"""Audited integer primitives matching C89 semantics.

The reference is integer-only C; its arithmetic idioms (truncating division,
arithmetic shift right, integer sqrt) must be reproduced exactly for
bit-exactness (ref: src/dsv.h:65-78, src/sbt.c:93-103, src/hme.c:100-124).

Every function has two homes: plain-int/numpy (host) here, and the same
names for int32 torch tensors in dsv2_tpu_torch.ops.tint.
"""
import numpy as np


def sar(v, s):
    """Arithmetic shift right == floordiv by power of two (ref: dsv.h:71-75)."""
    if isinstance(v, (int, np.integer)):
        return int(v) >> s
    return v >> s


def sar_r(v, s):
    """Rounding arithmetic shift right (ref: dsv.h:78)."""
    return sar(v + (1 << (s - 1)), s)


def divt(a, b):
    """C truncating integer division (rounds toward zero)."""
    if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
        q = abs(int(a)) // abs(int(b))
        return -q if (a < 0) != (b < 0) else q
    a = np.asarray(a)
    b = np.asarray(b)
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def modt(a, b):
    """C truncating modulo: a - divt(a,b)*b."""
    return a - divt(a, b) * b


def round2(v):
    """(v + sign) / 2 with truncating division (ref: sbt.c:93-97)."""
    if isinstance(v, (int, np.integer)):
        return divt(v + (-1 if v < 0 else 1), 2)
    v = np.asarray(v)
    return divt(v + np.where(v < 0, -1, 1), 2)


def round4(v):
    """(v + 2*sign) / 4 with truncating division (ref: sbt.c:99-103)."""
    if isinstance(v, (int, np.integer)):
        return divt(v + (-2 if v < 0 else 2), 4)
    v = np.asarray(v)
    return divt(v + np.where(v < 0, -2, 2), 4)


def round_shift(x, shift):
    """Ceil-ish rounding shift (ref: dsv.h:65)."""
    return (x + (1 << shift) - 1) >> shift


def round_pow2(x, pwr):
    """Round up to a multiple of 2**pwr (ref: dsv.h:66)."""
    return (x + (1 << pwr) - 1) & ~((1 << pwr) - 1)


def udiv_round_up(a, b):
    return (a + b - 1) // b


def udiv_round(a, b):
    return (a + b // 2) // b


def lb2(n):
    """Smallest s with (1<<s) >= n; lb2(0) == 0 (ref: dsv.c:449-459)."""
    n = int(n)
    i, log2 = 1, 0
    while i < n:
        i <<= 1
        log2 += 1
    return log2


def nlevels(w, h):
    """Number of subband transform levels (ref: sbt.c:833-845)."""
    mx = max(w, h)
    l = lb2(mx)
    if mx > (1 << l):
        l += 1
    return l


def iisqrt(n):
    """Integer sqrt, floor(sqrt(n)) for n >= 0 (ref: hme.c:100-124)."""
    if isinstance(n, (int, np.integer)):
        import math
        return math.isqrt(int(n))
    n = np.asarray(n, dtype=np.int64)
    r = np.floor(np.sqrt(n.astype(np.float64))).astype(np.int64)
    # correct any float rounding
    r = np.where((r + 1) * (r + 1) <= n, r + 1, r)
    r = np.where(r * r > n, r - 1, r)
    return r


def clamp(x, lo, hi):
    if isinstance(x, (int, np.integer)):
        return lo if x < lo else (hi if x > hi else x)
    return np.clip(x, lo, hi)


def s2u(v):
    """Signed to unsigned zig-zag (ref: bs.c:161-165)."""
    v = int(v)
    return 2 * v if v >= 0 else -2 * v - 1


def u2s(uv):
    """Unsigned zig-zag to signed (ref: bs.c:167-171)."""
    uv = int(uv)
    return (uv >> 1) ^ -(uv & 1)
