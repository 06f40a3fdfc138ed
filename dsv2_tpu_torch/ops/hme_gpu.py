"""The motion search on the card: launch wrappers of the hand-written
CUDA kernels in csrc/hme_search.cu (one stream) and csrc/hme_gang.cu
(every stream lane of a lockstep flush).

The counterpart of `dsv2_tpu/ops/hme_pallas.py` (the TPU's Pallas
kernels `_level_call` and `_level0_call`). `make_motion_est(cfg)` has the
inputs and the output dict of `hme_wave.make_motion_est`: for CPU
tensors it is that plain version; for CUDA tensors each upper pyramid
level is one `hme_level` launch and the base level one `hme_level0`
launch, the global motion between them a few torch ops, so the search
never syncs with the host. A CUDA tensor never reaches the plain
version. `make_motion_est_lanes(cfg)` is the builder the encoder runs
(key ("hme_pl", cfg)): the lanes of a flush one after another, a lone
stream's search a flush of one lane.
`hme_gang_level`/`hme_gang_level0` launch kernels 6/7 for a list of
lanes (ops/hme_gang builds the search from them).
Each launch counts as `launch.<wrapper name>` (utils/trace).

Layout: the TPU kernels walk the anti-diagonals as a sequential grid,
keep the last three diagonals in an SMEM ring and get every parent and
temporal candidate pre-gathered per diagonal in XLA, then unskew the
rows. Here every level spreads its blocks (every lane's, under the gang
kernel; an upper level's ca x cb blocks at multiples of its step) over
CTAs on every SM, each block claimed in topological order and finished
once its left and top neighbours are published, the part of its search
that needs no neighbour done before it waits (csrc/hme_sched.cuh; the
wrapper zeroes the scheduler's scratch, a ticket and a ready flag per
block). A warp searches one block, its lanes splitting the pixel loops,
reads its neighbours,
parents and temporal candidates straight from the (nbv, nbh) grids and
writes its results into them. The planes stay the bordered uint8
planes; a window is read at its start clamped into the plane, exactly
like the plain version's.
"""
import numpy as np
import torch

from ..core import constants as K
from ..utils import trace
from . import hme_wave as hw

_I32 = torch.int32
NF0 = 7            # level-0 fields: fx, fy, flags, err, dc, submask, fskip
GEOM = ("nbh", "nbv", "blk_w", "blk_h", "vid_w", "vid_h", "hs", "vs",
        "effort", "lossless", "levels", "has_tmv", "skip_neg", "level",
        "fw", "fh", "W", "H", "CW", "CH", "quant", "skip_thresh", "psyf",
        "b2sr")

# blocks per warp of the gang kernels (a block gets 32 // GANG lanes):
# 1, 2 or 4. 1 was fastest at the lockstep cell's CIF levels 0-1 on an
# H100 (chip_smoke.py phase hme_gang_vs_plain; PERF.md, kernels 6/7)
GANG = 1
LANES_PER_LAUNCH = 32   # the most lanes a gang launch takes (hme_gang.cu)


def geometry(cfg, level, planes, chroma, quant, skip_thresh):
    """The int32 parameter block of one launch (GEOM order)."""
    fw, fh = cfg.dims[level]
    H, W = planes[0].shape
    CH, CW = chroma[0].shape if chroma else (0, 0)
    vals = dict(nbh=cfg.nbh, nbv=cfg.nbv, blk_w=cfg.blk_w, blk_h=cfg.blk_h,
                vid_w=cfg.vid_w, vid_h=cfg.vid_h,
                hs=K.fmt_h_shift(cfg.subsamp), vs=K.fmt_v_shift(cfg.subsamp),
                effort=cfg.effort, lossless=int(cfg.lossless),
                levels=cfg.pyramid_levels, has_tmv=int(cfg.has_tmv),
                skip_neg=int(cfg.skip_thresh_neg), level=level, fw=fw, fh=fh,
                W=W, H=H, CW=CW, CH=CH, quant=quant, skip_thresh=skip_thresh,
                psyf=cfg.psyf_all, b2sr=_b2sr(cfg, quant))
    return np.array([vals[k] for k in GEOM], dtype=np.int32)


def _b2sr(cfg, quant):
    """The motion vector cost's bits-to-score ratio at `quant`."""
    return ((256 * ((quant * quant) >> K.MAX_QP_BITS)
             * (cfg.blk_w * cfg.blk_h)) // (cfg.vid_w * cfg.vid_h))


def _check(cfg, level, planes, chroma, grids, out):
    dev = planes[0].device
    for p in planes + chroma:
        if p.dtype != torch.uint8 or p.dim() != 2 or not p.is_contiguous():
            raise ValueError("planes must be contiguous 2-D uint8, got %s %s"
                             % (p.dtype, tuple(p.shape)))
        if p.device != dev:
            raise ValueError("plane on %s, expected %s" % (p.device, dev))
    fw, fh = cfg.dims[level]
    for p in planes:
        if tuple(p.shape) != tuple(planes[0].shape):
            raise ValueError("luma planes of a level differ in shape")
    H, W = planes[0].shape
    if H < fh + 2 * hw.B or W < fw + 2 * hw.B:
        raise ValueError("level %d plane %s smaller than %dx%d + border"
                         % (level, tuple(planes[0].shape), fw, fh))
    for t in grids + (out,):
        if t.dtype != _I32 or not t.is_contiguous() or t.device != dev:
            raise ValueError("grids must be contiguous int32 on %s" % dev)
        if tuple(t.shape[-2:]) != (cfg.nbv, cfg.nbh):
            raise ValueError("grid shape %s, expected (..., %d, %d)"
                             % (tuple(t.shape), cfg.nbv, cfg.nbh))


def hme_level(cfg, level, src, ref, ogr, parent, tmv, gxy, quant):
    """One upper pyramid level on the card (kernel 4): returns the (2, nbv,
    nbh) int32 fields (fx, fy) in full-resolution full-pel units. parent
    and tmv are (2, nbv, nbh) int32, gxy (2,) int32 (global motion)."""
    from . import _kernels
    out = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=_I32, device=src.device)
    _check(cfg, level, [src, ref, ogr], [], (parent, tmv), out)
    if gxy.dtype != _I32 or tuple(gxy.shape) != (2,):
        raise ValueError("gxy must be int32 (2,)")
    geom = geometry(cfg, level, [src], [], quant, 0)
    _kernels.hme_level(src, ref, ogr, parent, tmv, gxy, out,
                       _sched(cfg, 1, src.device, level), geom)
    trace.count("launch.hme_level")
    return out


def _sched(cfg, lanes, dev, level=0):
    """The zeroed scratch of the scheduler of `level`: a ticket and a
    ready flag per block of every lane (an upper level's blocks: its ca x
    cb grid at a step of 2^level)."""
    _, ca, cb, _ = hw.lane_grid(cfg, level)
    return torch.zeros(1 + lanes * ca * cb, dtype=_I32, device=dev)


def hme_level0(cfg, src, ref, ogr, chroma, parent, tmv, gxy, quant,
               skip_thresh):
    """The base level on the card (kernel 5): returns ((NF0, nbv, nbh)
    int32 fields fx, fy, flags, err, dc, submask, fskip; (4,) int32 sums
    terr, ndiff, nelig, nintra). chroma = (src_u, src_v, ref_u, ref_v)."""
    from . import _kernels
    dev = src.device
    out = torch.zeros((NF0, cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
    sums = torch.zeros(4, dtype=_I32, device=dev)
    _check(cfg, 0, [src, ref, ogr], list(chroma), (parent, tmv), out)
    if len({tuple(c.shape) for c in chroma}) != 1:
        raise ValueError("chroma planes differ in shape")
    geom = geometry(cfg, 0, [src], list(chroma), quant, skip_thresh)
    _kernels.hme_level0(src, ref, ogr, chroma, parent, tmv, gxy, out, sums,
                        _sched(cfg, 1, dev), geom)
    trace.count("launch.hme_level0")
    return out, sums


def _gang_args(cfg, level, lanes, parent, tmv, gxy, out, sums, quants,
               skip_threshs, gang):
    """Checks of one gang launch; returns (geom, ptrs, scal). lanes: per
    lane (luma planes, chroma planes); parent, tmv, out (L, NF, nbv, nbh),
    gxy (L, 2), sums (L, 4) or None, int32 on the planes' device."""
    n = len(lanes)
    if not 1 <= n <= LANES_PER_LAUNCH:
        raise ValueError("a gang launch takes 1 to %d lanes, got %d"
                         % (LANES_PER_LAUNCH, n))
    if gang not in (1, 2, 4):
        raise ValueError("gang must be 1, 2 or 4 blocks per warp")
    if len(quants) != n or len(skip_threshs) != n:
        raise ValueError("one quant and skip threshold per lane")
    planes0, chroma0 = lanes[0]
    for planes, chroma in lanes:
        _check(cfg, level, planes, chroma, (), out[0])
        if planes[0].device != planes0[0].device:
            raise ValueError("lanes on different devices")
        if [tuple(p.shape) for p in planes + chroma] != [
                tuple(p.shape) for p in planes0 + chroma0]:
            raise ValueError("lanes' planes differ in shape")
    for t in (parent, tmv, out, gxy) + ((sums,) if sums is not None else ()):
        if (t.dtype != _I32 or not t.is_contiguous() or t.shape[0] != n
                or t.device != planes0[0].device):
            raise ValueError("per-lane grids must be contiguous int32 "
                             "(lanes, ...) on the planes' device")
    _check(cfg, level, list(planes0), list(chroma0), (parent[0], tmv[0]),
           out[0])
    if tuple(gxy.shape) != (n, 2):
        raise ValueError("gxy must be (lanes, 2)")
    geom = geometry(cfg, level, list(planes0), list(chroma0), 0, 0)
    ptrs = np.zeros((n, 12), dtype=np.int64)
    for i, (planes, chroma) in enumerate(lanes):
        row = [p.data_ptr() for p in planes]
        row += [p.data_ptr() for p in chroma] or [0] * 4
        row += [parent[i].data_ptr(), tmv[i].data_ptr(), gxy[i].data_ptr(),
                out[i].data_ptr(),
                sums[i].data_ptr() if sums is not None else 0]
        ptrs[i] = row
    scal = np.array([(q, s, _b2sr(cfg, q))
                     for q, s in zip(quants, skip_threshs)],
                    dtype=np.int32).reshape(n, 3)
    return geom, ptrs, scal


def hme_gang_level(cfg, level, srcs, refs, ogrs, parent, tmv, gxy, quants,
                   gang=None):
    """One upper pyramid level of every lane on the card (kernel 6, one
    launch for up to LANES_PER_LAUNCH lanes): srcs/refs/ogrs are the
    lanes' level planes, parent and tmv (L, 2, nbv, nbh) int32, gxy (L, 2)
    int32, quants L ints. Returns the (L, 2, nbv, nbh) int32 fields."""
    from . import _kernels
    n = len(srcs)
    out = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=_I32,
                      device=srcs[0].device)
    for lo in range(0, n, LANES_PER_LAUNCH):
        sl = slice(lo, lo + LANES_PER_LAUNCH)
        lanes = [([s, r, o], []) for s, r, o in zip(srcs[sl], refs[sl],
                                                     ogrs[sl])]
        m = len(lanes)
        geom, ptrs, scal = _gang_args(
            cfg, level, lanes, parent[sl], tmv[sl], gxy[sl], out[sl], None,
            quants[sl], [0] * m, gang or GANG)
        _kernels.hme_gang(False, 32 // (gang or GANG), geom, ptrs, scal,
                          srcs[0].device,
                          _sched(cfg, m, srcs[0].device, level))
        trace.count("launch.hme_gang_level")
    return out


def hme_gang_level0(cfg, srcs, refs, ogrs, chromas, parent, tmv, gxy,
                    quants, skip_threshs, gang=None):
    """The base level of every lane on the card (kernel 7, one launch for
    up to LANES_PER_LAUNCH lanes): chromas are the lanes' (src_u, src_v,
    ref_u, ref_v). Returns ((L, NF0, nbv, nbh) int32 fields, (L, 4) int32
    sums), as hme_level0 per lane."""
    from . import _kernels
    n = len(srcs)
    dev = srcs[0].device
    out = torch.zeros((n, NF0, cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
    sums = torch.zeros((n, 4), dtype=_I32, device=dev)
    for lo in range(0, n, LANES_PER_LAUNCH):
        sl = slice(lo, lo + LANES_PER_LAUNCH)
        lanes = [([s, r, o], list(c)) for s, r, o, c in zip(
            srcs[sl], refs[sl], ogrs[sl], chromas[sl])]
        for _, c in lanes:
            if len({tuple(p.shape) for p in c}) != 1:
                raise ValueError("chroma planes differ in shape")
        geom, ptrs, scal = _gang_args(
            cfg, 0, lanes, parent[sl], tmv[sl], gxy[sl], out[sl], sums[sl],
            quants[sl], skip_threshs[sl], gang or GANG)
        _kernels.hme_gang(True, 32 // (gang or GANG), geom, ptrs, scal, dev,
                          _sched(cfg, len(lanes), dev))
        trace.count("launch.hme_gang_level0")
    return out, sums


def _device_search(cfg, src_planes, ref_planes, ogr_planes, src_u, src_v,
                   ref_u, ref_v, tmv_x, tmv_y, quant, skip_thresh):
    dev = src_planes[0].device
    quant, skip_thresh = int(quant), int(skip_thresh)
    tmv = torch.stack([tmv_x, tmv_y]).to(_I32).contiguous()
    gxy = torch.zeros(2, dtype=_I32, device=dev)
    parent = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
    for level in range(cfg.pyramid_levels, 0, -1):
        parent = hme_level(cfg, level, src_planes[level], ref_planes[level],
                           ogr_planes[level], parent, tmv, gxy, quant)
        gx, gy = hw.global_motion_graph(cfg, level, parent[0], parent[1])
        gxy = torch.stack([gx, gy])
    out, sums = hme_level0(cfg, src_planes[0], ref_planes[0], ogr_planes[0],
                           (src_u, src_v, ref_u, ref_v), parent, tmv, gxy,
                           quant, skip_thresh)
    st = dict(zip(hw.FIELDS0, out[:6]))
    st["fskip"] = out[6].to(torch.uint8)
    st.update(zip(hw.SUMS0, sums))
    return st


def make_motion_est(cfg):
    """fn(src_planes, ref_planes, ogr_planes, src_u, src_v, ref_u, ref_v,
    tmv_x, tmv_y, quant, skip_thresh) -> the output dict of
    hme_wave.make_motion_est: the kernels for CUDA tensors, the plain
    version for CPU tensors, an error for anything else."""
    plain = hw.make_motion_est(cfg)

    def f(src_planes, *rest):
        dev = src_planes[0].device
        if dev.type == "cpu":
            return plain(src_planes, *rest)
        if dev.type != "cuda":
            raise ValueError("no motion search for device %s" % dev)
        return _device_search(cfg, src_planes, *rest)

    return f


def make_motion_est_lanes(cfg):
    """The builder of key ("hme_pl", cfg): fn(lanes) -> the output dicts
    of make_motion_est, one per lane, the lanes searched one after
    another (kernels 4/5 on the card)."""
    fn = make_motion_est(cfg)
    return lambda lanes: [fn(*inputs) for inputs in lanes]


def motion_est(enc, d):
    """Search frame d against its reference with kernels 4/5 (backend
    "pallas"), a lane of key ("hme_pl", cfg) through the encoder's
    `dev_submit`."""
    cfg, inputs = hw.prepare_motion_est(enc, d)
    st = enc.dev_submit(("hme_pl", cfg), make_motion_est_lanes, inputs,
                        fetch=True)
    hw.apply_motion_est(enc, d, st)
