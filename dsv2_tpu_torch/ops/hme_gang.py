"""The gang motion search: every stream lane of a lockstep flush in one
launch per pyramid level (port of `dsv2_tpu/ops/hme_gang.py`).

On the TPU the gang kernels pack G blocks of an anti-diagonal side by
side on the 128-lane vector rows, and under lockstep `jax.vmap` gives
their grid a lane axis (`dsv2_tpu/parallel/dynbatch.py:275`). Here
`make_motion_est(cfg)` takes the lanes explicitly: fn(lanes), `lanes` a
list of per-lane inputs of `hme_wave.make_motion_est` (planes, chroma,
temporal field, quant, skip threshold), returns that function's output
dict with a leading lane dimension (fields (L, nbv, nbh), sums (L,)).
For CUDA tensors each upper level is one `hme_gpu.hme_gang_level` launch
(kernel 6, csrc/hme_gang.cu) and the base level one `hme_gang_level0`
launch (kernel 7), each covering every lane; the global motion between
levels is computed per lane by a few torch ops, so the search never
syncs with the host. For CPU tensors it is the plain version
(`hme_wave`) lane by lane. A CUDA tensor never reaches the plain version.
"""
import torch

from . import hme_gpu, hme_wave as hw, tint

_I32 = torch.int32


def global_motion_lanes(cfg, level, fields):
    """hme_wave.global_motion_graph of every lane: fields (L, 2, nbv, nbh)
    int32 -> (L, 2) int32 (gx, gy)."""
    step, ca, cb, _ = hw.lane_grid(cfg, level)
    s = fields[:, :, 0::step, 0::step].sum(dim=(2, 3), dtype=_I32)
    return tint.divt(s * 2, ca * cb)


def _device_search(cfg, lanes, gang):
    n = len(lanes)
    srcs, refs, ogrs = ([ln[k] for ln in lanes] for k in range(3))
    chromas = [tuple(ln[3:7]) for ln in lanes]
    dev = srcs[0][0].device
    tmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]).to(
        _I32).contiguous()
    quants = [int(ln[9]) for ln in lanes]
    skip_threshs = [int(ln[10]) for ln in lanes]
    gxy = torch.zeros((n, 2), dtype=_I32, device=dev)
    parent = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
    for level in range(cfg.pyramid_levels, 0, -1):
        parent = hme_gpu.hme_gang_level(
            cfg, level, [s[level] for s in srcs], [r[level] for r in refs],
            [o[level] for o in ogrs], parent, tmv, gxy, quants, gang)
        gxy = global_motion_lanes(cfg, level, parent)
    out, sums = hme_gpu.hme_gang_level0(
        cfg, [s[0] for s in srcs], [r[0] for r in refs],
        [o[0] for o in ogrs], chromas, parent, tmv, gxy, quants,
        skip_threshs, gang)
    st = {k: out[:, i] for i, k in enumerate(hw.FIELDS0)}
    st["fskip"] = out[:, 6].to(torch.uint8)
    st.update((k, sums[:, i]) for i, k in enumerate(hw.SUMS0))
    return st


def make_motion_est(cfg, gang=None):
    """fn(lanes) -> the output dict of hme_wave.make_motion_est with a
    leading lane dimension; `gang` blocks per warp (default
    hme_gpu.GANG). The kernels for CUDA tensors, the plain version lane
    by lane for CPU tensors, an error for anything else."""
    plain = hw.make_motion_est(cfg)

    def f(lanes):
        lanes = list(lanes)
        dev = lanes[0][0][0].device
        if any(ln[0][0].device != dev for ln in lanes):
            raise ValueError("lanes on different devices")
        if dev.type == "cpu":
            sts = [plain(*ln) for ln in lanes]
            return {k: torch.stack([st[k] for st in sts]) for k in sts[0]}
        if dev.type != "cuda":
            raise ValueError("no motion search for device %s" % dev)
        return _device_search(cfg, lanes, gang)

    return f


def motion_est(enc, d):
    """Search frame d against its reference with the gang kernels (backend
    "gang"): through the encoder's lockstep batcher (key ("hme_gang",
    cfg)) when it has one, else as a batch of one lane."""
    cfg, inputs = hw.prepare_motion_est(enc, d)
    submit = getattr(enc, "dev_submit", None)
    if submit is not None:
        st = submit(("hme_gang", cfg), make_motion_est, inputs, fetch=True)
    else:
        st = {k: v[0] for k, v in make_motion_est(cfg)([inputs]).items()}
    hw.apply_motion_est(enc, d, st)
