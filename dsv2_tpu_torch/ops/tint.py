"""C89-exact integer arithmetic on int32 torch tensors.

Port of `dsv2_tpu/ops/jint.py`, plus the two integer helpers the slice
needs from elsewhere: `isqrt_u32` (`dsv2_tpu/ops/hme_wave.py`) and
`ilog2` (`dsv2_tpu/ops/scan_pl.py::_ilog2`). Shifts on signed ints are
arithmetic; every division that can see a negative operand truncates
(`divt`), never floors (ref idioms: src/dsv.h:71-78, src/sbt.c:93-103).
"""
import functools

import torch


def _i32(x):
    if x.dtype != torch.int32:
        raise TypeError("expected int32, got %s" % x.dtype)
    return x


def divt(a, b):
    """Truncating (C) integer division; b is a positive python int or an
    int32 tensor."""
    _i32(a)
    if isinstance(b, int) and b > 0:
        q = torch.div(a.abs(), b, rounding_mode="floor")
        return torch.where(a < 0, -q, q)
    _i32(b)
    q = torch.div(a.abs(), b.abs(), rounding_mode="floor")
    return torch.where((a < 0) != (b < 0), -q, q)


def sar(v, s):
    return _i32(v) >> s


def sar_r(v, s):
    return (_i32(v) + (1 << (s - 1))) >> s


def round2(v):
    _i32(v)
    return divt(torch.where(v < 0, v - 1, v + 1), 2)


def round4(v):
    _i32(v)
    return divt(torch.where(v < 0, v - 2, v + 2), 4)


def clamp(x, lo, hi):
    return torch.clamp(_i32(x), lo, hi)


def clamp_u8(x):
    return torch.clamp(_i32(x), 0, 255)


def isqrt_u32(n):
    """Integer sqrt (floor) of uint32-ranged values (ref: hme.c:100-124).
    n: int32 tensor whose bits are read as uint32 (as the JAX twin's
    astype(uint32) does); carried in int64 since torch has few uint32
    ops. Returns int32."""
    n = _i32(n).to(torch.int64) & 0xFFFFFFFF
    res = torch.zeros_like(n)
    rem = n
    for k in range(16):
        pos = 1 << (30 - 2 * k)
        dif = res + pos
        take = rem >= dif
        rem = torch.where(take, rem - dif, rem)
        res = (res >> 1) + take.to(torch.int64) * pos
    return res.to(torch.int32)


def ilog2(x):
    """floor(log2(x)) for x >= 1; -1 for x <= 0 (int32). torch has no
    count-leading-zeros, so this is a 5-step binary shift search (exact,
    unlike float log2)."""
    _i32(x)
    y = torch.clamp(x, min=0)
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        m = (y >> s) != 0
        r = r + m.to(torch.int32) * s
        y = torch.where(m, y >> s, y)
    return torch.where(x > 0, r, -1)


def on_device(device, fn, *args):
    """fn(*args) -> numpy index array(s), as tensors on `device`, cached
    per (device, fn, args): static gather tables are built and uploaded
    once, so no host->device copy (and no stream sync) happens on the
    device path."""
    return _on_device(torch.device(device), fn, args)


@functools.lru_cache(maxsize=None)
def _on_device(device, fn, args):
    out = fn(*args)
    if isinstance(out, tuple):
        return tuple(torch.as_tensor(o, device=device) for o in out)
    return torch.as_tensor(out, device=device)
