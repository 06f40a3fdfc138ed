#!/usr/bin/env python
"""Card-side cost probes for the gang-packed motion-search layout (port
of tools/probe_gang.py; the CUDA kernels are csrc/probe_gang.cu).

The motion-search kernels give one block a tile of lanes; the gang
kernels pack several blocks per warp. The probes time one metric chain
per evaluation in both layouts, as the TPU tool did with its Pallas
kernels: a sequential walker over NB blocks of EVALS metric evaluations
each, per block (a warp per 16x16 window) or ganged (G = 8 windows side
by side as one 16x128 tile), in three modes (full; read: the window
reads only; compute: the metric only), plus a load at a computed index.
Each probe is held against its plain PyTorch version (block_plain,
gang_plain, scalar_plain), which repeat the TPU tool's arithmetic with
its quirks: the gang metric's horizontal roll wraps across the whole
128-wide tile and each evaluation overwrites the gang's sums, so gang
and block differ; gang/read writes window 0's pixel to every slot;
block/compute adds x, gang/compute does not (and tiles the 16x16 window
8 times, where the TPU tool's broadcast does not trace).

    python -m dsv2_tpu_torch.tools.probe_gang [reps]

On the card (the default) it prints the ns per metric evaluation of the
six variants (CUDA events), each probe's agreement with its plain
version and the block/gang parity line; with DSV2_TORCH_DEVICE=cpu it
runs the plain versions only (host times, not a device metric).
"""
import json
import sys
import time

import numpy as np
import torch

G = 8            # windows per gang (16 px * 8 = 128 columns)
BW = 16
NB = 704         # blocks (CIF level 0 has 22 * 18 = 396)
EVALS = 16       # metric evaluations per block
HP, WP = 320, 512
MODES = ("full", "read", "compute")
VARIANTS = ("block", "gang")

launches = {"block": 0, "gang": 0, "scalar": 0}


def inputs(nb=NB, seed=7, device="cpu"):
    """(plane (HP, WP) uint8, cx, cy (nb,) int32) drawn as the TPU tool
    draws them (its per-evaluation offsets, read by no kernel, are drawn
    and dropped so the stream of draws matches)."""
    rng = np.random.RandomState(seed)
    plane = rng.randint(0, 256, (HP, WP), np.uint8)
    cx = rng.randint(8, WP - 64, nb).astype(np.int32)
    cy = rng.randint(8, HP - 64, nb).astype(np.int32)
    rng.randint(-4, 5, (nb, EVALS, 2))
    return tuple(torch.as_tensor(a).to(device) for a in (plane, cx, cy))


def _metr(a, b):
    """tools/probe_gang.py:70-76 on (..., h, w) int32 tiles: the rolls
    wrap over the last two dimensions."""
    d = (a - b).abs()
    xr = d + torch.roll(d, -1, -1)
    se = (xr + torch.roll(xr, -1, -2) + 2) >> 2
    return se * se + ((a - b) * (a - b) << 1) + ((a >> 1) - (b >> 1)) ** 2


def _windows(plane, cx, cy):
    """(nb, 16, 16) int32 windows at the clipped block coordinates."""
    hp, wp = plane.shape
    yy = cy.long().clamp(0, hp - BW)
    xx = cx.long().clamp(0, wp - BW)
    r = torch.arange(BW, device=plane.device)
    return plane[(yy[:, None] + r)[:, :, None],
                 (xx[:, None] + r)[:, None, :]].to(torch.int32)


def _sum_metr(w):
    return _metr(w, torch.roll(w, 1, -2)).sum(dim=(-2, -1), dtype=torch.int32)


def block_plain(mode, plane, cx, cy, evals=EVALS):
    """The per-block probe (tools/probe_gang.py:84-104): (nb,) int32."""
    if mode == "read":
        return _windows(plane, cx, cy)[:, 0, 0] * evals
    if mode == "compute":
        w = plane[:BW, :BW].to(torch.int32) + cx[:, None, None]
    else:
        w = _windows(plane, cx, cy)
    return _sum_metr(w) * evals


def gang_plain(mode, plane, cx, cy, evals=EVALS):
    """The ganged probe (tools/probe_gang.py:129-159): (nb,) int32, the
    slots past the last whole gang 0."""
    nb = cx.shape[0]
    nit = nb // G
    out = torch.zeros(nb, dtype=torch.int32, device=plane.device)
    if mode == "compute":
        w = plane[:BW, :BW].to(torch.int32).repeat(1, G)[None].expand(
            nit, BW, BW * G)
    else:
        w = _windows(plane, cx[:nit * G], cy[:nit * G]).view(
            nit, G, BW, BW).permute(0, 2, 1, 3).reshape(nit, BW, BW * G)
    if mode == "read":
        out[:nit * G] = w[:, 0, 0].repeat_interleave(G)
        return out
    rows = _metr(w, torch.roll(w, 1, -2)).sum(dim=-2, dtype=torch.int32)
    out[:nit * G] = rows.view(nit, G, BW).sum(dim=-1,
                                              dtype=torch.int32).reshape(-1)
    return out


def scalar_plain(plane):
    """The computed-index load (tools/probe_gang.py:184-191): (128,)
    int32."""
    v = plane[:8, :128].to(torch.int32)
    idx = (v[0].sum() + torch.arange(128, device=plane.device)) % 8
    return v[idx, 0]


def _check(plane, cx, cy):
    if plane.dtype != torch.uint8 or plane.dim() != 2 or \
            not plane.is_contiguous():
        raise ValueError("plane must be a contiguous 2-D uint8 tensor")
    if plane.shape[0] < BW or plane.shape[1] < BW * G:
        raise ValueError("plane must be at least %dx%d" % (BW * G, BW))
    for t in (cx, cy):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != plane.device or t.shape != cx.shape:
            raise ValueError("cx, cy must be contiguous (nb,) int32 on the "
                             "plane's device")


def _probe(variant, plain, mode, plane, cx, cy, evals):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if plane.device.type == "cpu":
        return plain(mode, plane, cx, cy, evals)
    if plane.device.type != "cuda":
        raise ValueError("no probe for device %s" % plane.device)
    from ..ops import _kernels
    _check(plane, cx, cy)
    out = torch.zeros(cx.shape[0], dtype=torch.int32, device=plane.device)
    _kernels.probe_gang(VARIANTS.index(variant), MODES.index(mode), plane,
                        cx, cy, out, cx.shape[0], evals)
    launches[variant] += 1
    return out


def block(mode, plane, cx, cy, evals=EVALS):
    """The per-block probe (a warp per window) in `mode`: (nb,) int32."""
    return _probe("block", block_plain, mode, plane, cx, cy, evals)


def gang(mode, plane, cx, cy, evals=EVALS):
    """The ganged probe (8 windows per warp) in `mode`: (nb,) int32."""
    return _probe("gang", gang_plain, mode, plane, cx, cy, evals)


def scalar(plane):
    """The computed-index load probe: (128,) int32."""
    if plane.device.type == "cpu":
        return scalar_plain(plane)
    if plane.device.type != "cuda":
        raise ValueError("no probe for device %s" % plane.device)
    from ..ops import _kernels
    z = torch.zeros(1, dtype=torch.int32, device=plane.device)
    _check(plane, z, z)
    out = torch.zeros(128, dtype=torch.int32, device=plane.device)
    _kernels.probe_gang(2, 0, plane, z, z, out, 0, 0)
    launches["scalar"] += 1
    return out


def _time_ms(fn, reps, cuda):
    """Mean ms of fn() over reps calls after one warm-up call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run(device, reps=20, nb=NB, evals=EVALS):
    """Every probe on `device` against its plain version; returns the
    records (variant, mode, ms, ns per evaluation, max_abs_err against
    the plain version), the scalar probe's and the block/gang parity
    (mismatching blocks of the full mode, as tools/probe_gang.py:224-228
    counts them). On the CPU the probes are the plain versions and the
    times are host times."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    plane, cx, cy = inputs(nb, device=dev)
    recs, full = [], {}
    for variant, probe, plain in (("block", block, block_plain),
                                  ("gang", gang, gang_plain)):
        for mode in MODES:
            got = probe(mode, plane, cx, cy, evals)
            want = plain(mode, plane, cx, cy, evals)
            err = int((got.long() - want.long()).abs().max())
            ms = _time_ms(lambda: probe(mode, plane, cx, cy, evals), reps,
                          cuda)
            recs.append(dict(variant=variant, mode=mode, ms=ms,
                             ns_per_eval=ms * 1e6 / (nb * evals),
                             max_abs_err=err))
            if mode == "full":
                full[variant] = got
    got = scalar(plane)
    err = int((got.long() - scalar_plain(plane).long()).abs().max())
    recs.append(dict(variant="scalar", mode="load", max_abs_err=err,
                     ms=_time_ms(lambda: scalar(plane), reps, cuda)))
    mismatch = int((full["block"] != full["gang"]).sum())
    return dict(device=str(dev), nb=nb, evals=evals, gang=G, probes=recs,
                parity_mismatch_blocks=mismatch)


def main(argv=None):
    from .. import default_device
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 20
    dev = default_device()
    res = run(dev, reps)
    print("device=%s NB=%d EVALS=%d G=%d" % (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        NB, EVALS, G))
    for r in res["probes"]:
        if r["variant"] == "scalar":
            print("  scalar load @ computed idx: %8.3f ms / 128 loads "
                  "(err %d)" % (r["ms"], r["max_abs_err"]))
        else:
            print("  %-6s %-8s %8.3f ms (%7.1f ns/eval) err %d" % (
                r["variant"], r["mode"], r["ms"], r["ns_per_eval"],
                r["max_abs_err"]))
    n = res["parity_mismatch_blocks"]
    print("  parity: gang == block  OK" if n == 0
          else "  parity: MISMATCH (%d blocks)" % n)
    print(json.dumps(res))
    if any(r["max_abs_err"] for r in res["probes"]):
        sys.exit("probe_gang: a kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
