"""In-loop filters as an anti-diagonal wavefront: the sequential 4x4
deblock/dering filters of the reference (ref: src/bmc.c:51-659).

Port of `dsv2_tpu/ops/filters.py` (the layout, tile maps and step math)
and of the wavefront it runs, whose TPU kernels are
`dsv2_tpu/ops/filters_pl.py` `_run_wavefront_pl` and `_hbm_call`. Both
are replaced by one hand-written CUDA kernel, `csrc/wavefront_filter.cu`.

The reference scans FDIM tiles (luma and intra: 4x4 tiles; inter chroma:
whole blocks) in raster order, and each tile's 6-tap test window
overlaps writes of its left / up / up-right neighbours. Raster semantics
are reproduced with an anti-diagonal wavefront over ``d = i + 2*j``:

- a tile on diagonal d only reads pixels written by tiles on diagonals
  < d, and same-diagonal tiles write disjoint pixels, so each diagonal is
  one data-parallel step;
- every tile reads its (th+8, tw+8) window around the tile from a plane
  held inside zero margins (`_Lay.mr` rows above, `_Lay.mc` columns to
  the left), computes masked updates of its private copy, and the deltas
  are added back after every window of the diagonal was read.

The twin keeps the plane skewed so that each diagonal is one contiguous
strip (the TPU has no cheap gather); here the plane stays unskewed and
the plain version gathers each diagonal's windows with index tensors.
The CUDA kernel takes the skew back inside shared memory: each plane row
keeps a ring of the skewed columns of the moving strip, sized by
`wavefront_plan` (in a global-memory scratch for a plane no cluster of
CTAs holds, the counterpart of the twin's HBM-resident `_hbm_call`).
`wavefront_filter` dispatches: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor (or an error), never a fallback.

Parity oracles: `dsv2_tpu`'s filters (XLA and Pallas interpret mode) and
the port's native C filters (native/dsv2n.c dsvn_*_filter).
"""
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as K
from ..utils import trace
from . import tint

F_STABLE = 1 << K.STABLE_BIT
F_MAINTAIN = 1 << K.MAINTAIN_BIT
F_RINGING = 1 << K.RINGING_BIT

KINDS = ("intra", "luma", "chroma")
_NPROPS = {"intra": 1, "luma": 10, "chroma": 5}
_I32 = torch.int32


class _Lay(NamedTuple):
    """Static wavefront layout for a (tile-size, plane, grid) combination."""
    pw: int          # visible plane width
    ph: int          # visible plane height
    tw: int          # tile width (4 for luma; block width for chroma)
    th: int          # tile height
    ntx: int         # tiles per row in the wavefront grid
    nty: int         # tile rows
    L: int           # max lanes (tiles) on a diagonal
    nd: int          # number of diagonals
    mr: int          # top margin rows (whole tiles, >= 8)
    mc: int          # left margin cols
    HP: int          # padded plane rows
    WP: int          # padded plane cols
    wh: int          # window rows (th+8)
    ww: int          # window cols (tw+8)


def _layout(pw, ph, tw, th, ntx, nty):
    """The twin's `_layout` without the skew: same lanes, diagonals and
    margins. HP/WP bound every window: rows reach mr + nty*th + 3, cols
    mc + ntx*tw + 3 (ntx*tw < pw + tw). WP is a multiple of 4, so the
    kernel moves plane rows in 16-byte words."""
    L = max(1, min(nty, (ntx + 1) // 2))
    nd = (ntx - 1) + 2 * (nty - 1) + 1
    mr = -(-8 // th) * th
    mc = 8
    HP = mr + max(ph, nty * th) + 8
    WP = -(-(mc + pw + tw + 16) // 4) * 4
    return _Lay(pw, ph, tw, th, ntx, nty, L, nd, mr, mc, HP, WP,
                th + 8, tw + 8)


SMEM_OPTIN = 232448     # opt-in shared bytes per block on an H100
WF_MAX_THREADS = 512    # csrc/wavefront_filter.cu kMaxThreads
WF_PREFETCH = 12        # csrc/wavefront_filter.cu kPrefetch (words)
WF_CLUSTERS = (1, 2, 4, 8)


class WavefrontPlan(NamedTuple):
    """Launch plan of csrc/wavefront_filter.cu for one layout."""
    R: int           # ring width: skewed columns kept per plane row
    storage: str     # plane, ring and window element type in the kernel
    C: int           # CTAs per plane (a thread-block cluster when > 1)
    J: int           # tile rows per CTA
    LC: int          # lane windows per CTA
    wstride: int     # bytes per lane window
    rows: int        # ring rows of the largest CTA
    threads: int     # threads per CTA
    smem: int        # dynamic shared bytes per CTA
    ring: str = "shared"   # where the ring rows live: "shared" or "global"
    scratch: int = 0       # global scratch bytes per plane (ring "global")


def _check_layout(lay):
    """Raise ValueError unless `lay` is a layout `_layout` can produce
    with tiles of whole 4-pixel words no larger than a block (every codec
    layout is)."""
    want_L = max(1, min(lay.nty, (lay.ntx + 1) // 2))
    want_nd = (lay.ntx - 1) + 2 * (lay.nty - 1) + 1
    bad = [why for ok, why in (
        (lay.ntx >= 1 and lay.nty >= 1, "an empty tile grid"),
        (lay.tw >= 4 and lay.th >= 4 and lay.tw % 4 == 0
         and lay.th % 4 == 0, "tiles not whole 4-pixel words"),
        (lay.tw <= K.MAX_BLOCK_SIZE and lay.th <= K.MAX_BLOCK_SIZE,
         "tiles larger than a block"),
        (lay.wh == lay.th + 8 and lay.ww == lay.tw + 8, "window dims"),
        (lay.mr >= 8 and lay.mr % lay.th == 0, "top margin"),
        (lay.mc >= 8 and lay.mc % 4 == 0, "left margin"),
        (lay.L == want_L and lay.nd == want_nd, "lanes or diagonals"),
        (lay.HP >= lay.mr + lay.nty * lay.th + 8, "padded rows"),
        (lay.WP >= lay.mc + lay.ntx * lay.tw + 4 and lay.WP % 4 == 0,
         "padded cols")) if not ok]
    if bad:
        raise ValueError("malformed wavefront layout (%s): %s"
                         % (", ".join(bad), lay))


def _ring_bytes(lay, rows):
    """Bytes of the ring rows of one CTA (a padding word per band)."""
    return 4 * (rows * ((6 * lay.tw + 8) // 4) + rows // lay.th + 1)


def _threads(lay, rows, LC):
    """Threads of a CTA: one per lane window, and enough that each loads
    at most WF_PREFETCH words of the next diagonal's columns."""
    fill = -(-rows * (lay.tw // 4) // WF_PREFETCH)
    return min(WF_MAX_THREADS, 32 * -(-max(LC, fill) // 32))


def wavefront_plan(lay, cluster=None, max_smem=SMEM_OPTIN, ring=None):
    """Plan of the CUDA wavefront for layout `lay`: every plane row keeps
    a uint8 ring of R = 6*tw+8 skewed columns (the strip of 5*tw+8 a
    diagonal's windows cover plus the tw columns of the next one); each
    lane of a diagonal a private uint8 window. The ring lives in shared
    memory: a plane whose ring and windows exceed one CTA's `max_smem`
    bytes is split by tile rows over a cluster of C CTAs, the smallest C
    of 1, 2, 4, 8 that fits (or `cluster` itself). A plane no cluster
    holds (or `ring="global"`) runs on one CTA with its ring rows in a
    global-memory scratch of `scratch` bytes per plane, the windows in
    shared memory (after the ring in the scratch if even they exceed
    `max_smem`). `ring="shared"` takes no global plan. Raises ValueError
    on a malformed layout, or when the ring asked for has no plan."""
    _check_layout(lay)
    if ring not in (None, "shared", "global"):
        raise ValueError("no ring in %r memory" % (ring,))
    R = 6 * lay.tw + 8
    ws = lay.wh * lay.ww
    if (ws // 4) % 2 == 0:
        ws += 4      # an odd word stride: lanes' windows on distinct banks
    if ring == "global":
        if cluster not in (None, 1):
            raise ValueError("a global ring runs on one CTA, not %r"
                             % (cluster,))
        return _global_plan(lay, R, ws, max_smem)
    for C in (cluster,) if cluster else WF_CLUSTERS:
        if C not in WF_CLUSTERS:
            raise ValueError("no cluster of %r CTAs" % (C,))
        J = -(-lay.nty // C)
        if (C - 1) * J >= lay.nty:
            if cluster:
                raise ValueError("%d tile rows do not fill %d CTAs"
                                 % (lay.nty, C))
            continue
        span = J * lay.th
        rows = lay.HP if C == 1 else max(
            lay.mr + span, span, lay.HP - lay.mr - (C - 1) * span)
        LC = min(lay.L, J)
        smem = _ring_bytes(lay, rows) + LC * ws
        if smem <= max_smem:
            return WavefrontPlan(R, "uint8", C, J, LC, ws, rows,
                                 _threads(lay, rows, LC), smem)
    if ring is None and cluster is None:
        return _global_plan(lay, R, ws, max_smem)
    raise ValueError("wavefront layout %dx%d, tiles %dx%d: no cluster of "
                     "up to %d CTAs holds it in %d B each"
                     % (lay.pw, lay.ph, lay.tw, lay.th, WF_CLUSTERS[-1],
                        max_smem))


def _global_plan(lay, R, ws, max_smem):
    """The plan with the ring rows in global memory: one CTA, every row."""
    rows, LC = lay.HP, min(lay.L, lay.nty)
    wins = LC * ws
    smem = wins if wins <= max_smem else 0
    scratch = _ring_bytes(lay, rows) + (0 if smem else wins)
    return WavefrontPlan(R, "uint8", 1, lay.nty, LC, ws, rows,
                         _threads(lay, rows, LC), smem, "global",
                         -(-scratch // 16) * 16)


def _tile_maps(pw, ph, nbh, nbv):
    """Static tile->block maps (fx = i*nbh/nsbx with C semantics)."""
    nsbx, nsby = pw // 4, ph // 4
    ntx = max(0, (pw - 1) // 4)   # tiles with x+4 < pw
    nty = max(0, (ph - 1) // 4)
    fx = (np.arange(ntx) * nbh) // max(nsbx, 1)
    fy = (np.arange(nty) * nbv) // max(nsby, 1)
    return ntx, nty, fx, fy


def _neighbordif2_grids(mvx, mvy, flags):
    """Vectorized neighbordif2 over (..., nbv, nbh) block grids (ref:
    dsv.c:402-425 via native neighbordif2). Returns (ndx, ndy) int32."""
    cx, cy = mvx, mvy
    small = (cx.abs() < 2) & (cy.abs() < 2)
    skip = (flags >> K.MV_BIT_SKIP) & 1
    dev = cx.device

    def pick(sh_x, sh_y):
        nx = torch.roll(cx, (sh_y, sh_x), (-2, -1))
        ny = torch.roll(cy, (sh_y, sh_x), (-2, -1))
        nsk = torch.roll(skip, (sh_y, sh_x), (-2, -1))
        ok = ((nx != 0) | (ny != 0)) & (nsk == 0)
        if sh_x:
            ok = ok & (torch.arange(cx.shape[-1], device=dev)[None, :] > 0)
        if sh_y:
            ok = ok & (torch.arange(cx.shape[-2], device=dev)[:, None] > 0)
        return torch.where(ok, nx, cx), torch.where(ok, ny, cy)

    vx0, vy0 = pick(1, 0)   # left
    vx1, vy1 = pick(0, 1)   # top
    ndx = (vx0 - cx).abs() + (vy0 - cy).abs()
    ndy = (vx1 - cx).abs() + (vy1 - cy).abs()
    return torch.where(small, 0, ndx), torch.where(small, 0, ndy)


# ---------------------------------------------------------------------------
# window primitives: A is (..., L, wh, ww) int32, lane-private; per-lane
# values are (..., L). They update A in place and return it.
# ---------------------------------------------------------------------------

def _lpf6(e0, i0, e1, i1):
    return (5 * (e0 + i0) + 3 * (e1 + i1) + 8) >> 4


def _flat6(e2, e1, e0, i0, i1, i2, avg, t):
    return (((e0 - avg).abs() < t) & ((i0 - avg).abs() < t)
            & ((e1 - avg).abs() < t) & ((i1 - avg).abs() < t)
            & ((e2 - avg).abs() < t) & ((i2 - avg).abs() < t))


def _edge_pair(c, thE_, thM_, f_mask, fb_mask):
    """New values of the boundary pixels for the 11 taps c[0..10]
    (positions -3..7 around the boundary): the boundary at tap 3 writes
    taps 1..4, the interior one at tap 7 writes taps 6..9 (ref:
    bmc.c:51-191). Returns {tap: new value}."""
    e2, e1, e0, i0, i1, i2 = c[0], c[1], c[2], c[3], c[4], c[5]
    avg = _lpf6(e0, i0, e1, i1)
    f = _flat6(e2, e1, e0, i0, i1, i2, avg, thE_) & f_mask
    a5 = avg * 5
    new = {1: torch.where(f, (3 * (avg + e1) + 2 * e2 + 4) >> 3, e1),
           2: torch.where(f, (a5 + 2 * e1 + e2 + 4) >> 3, e0),
           3: torch.where(f, avg, i0),
           4: torch.where(f, (a5 + 2 * i1 + i2 + 4) >> 3, i1)}
    # interior boundary (reads taps 5..10: disjoint from the writes above,
    # like the C reads through the untouched pixels)
    i2b, i1b, i0b, e0b, e1b, e2b = c[5], c[6], c[7], c[8], c[9], c[10]
    avgb = _lpf6(e0b, i0b, e1b, i1b)
    fb = _flat6(e2b, e1b, e0b, i0b, i1b, i2b, avgb, thM_) & fb_mask
    a5b = avgb * 5
    new[6] = torch.where(fb, (a5b + 2 * i1b + i2b + 4) >> 3, i1b)
    new[7] = torch.where(fb, avgb, i0b)
    new[8] = torch.where(fb, (a5b + 2 * e1b + e2b + 4) >> 3, e0b)
    new[9] = torch.where(fb, (3 * (avgb + e1b) + 2 * e2b + 4) >> 3, e1b)
    return new


def _thresholds(edge, thE, thM, guard, in_edge):
    """(boundary threshold, interior threshold, boundary mask, interior
    mask), or None where no lane filters (the step then writes nothing:
    skipping it only saves time)."""
    g = guard & (thM > 0) & ~(edge & (thE <= 0))
    if not bool(g.any()):
        return None
    thE_ = torch.where(edge, thE, thM)[..., None]
    return thE_, thM[..., None], g[..., None], (g & in_edge)[..., None]


def _hfilt(A, ro, co, edge, thE, thM, guard, in_edge):
    """Filter the vertical boundary at window col `co`, rows ro..ro+3
    (ref: bmc.c:51-119). A threshold <= 0 writes nothing."""
    th = _thresholds(edge, thE, thM, guard, in_edge)
    if th is None:
        return A
    thE_, thM_, fm, fbm = th
    band = A[..., ro:ro + 4, co - 3:co + 8].clone()
    new = _edge_pair([band[..., k] for k in range(11)], thE_, thM_, fm, fbm)
    for k, v in new.items():
        A[..., ro:ro + 4, co - 3 + k] = v
    return A


def _vfilt(A, ro, co, edge, thE, thM, guard, in_edge):
    """Filter the horizontal boundary at window row `ro`, cols co..co+3
    (ref: bmc.c:121-191)."""
    th = _thresholds(edge, thE, thM, guard, in_edge)
    if th is None:
        return A
    thE_, thM_, fm, fbm = th
    band = A[..., ro - 3:ro + 8, co:co + 4].clone()
    new = _edge_pair([band[..., k, :] for k in range(11)], thE_, thM_, fm,
                     fbm)
    for k, v in new.items():
        A[..., ro - 3 + k, co:co + 4] = v
    return A


def _quads(t):
    d0 = (t[..., 0, 0] + t[..., 0, 1] + t[..., 1, 0] + t[..., 1, 1] + 2) >> 2
    d1 = (t[..., 0, 2] + t[..., 0, 3] + t[..., 1, 2] + t[..., 1, 3] + 2) >> 2
    d2 = (t[..., 2, 0] + t[..., 2, 1] + t[..., 3, 0] + t[..., 3, 1] + 2) >> 2
    d3 = (t[..., 2, 2] + t[..., 2, 3] + t[..., 3, 2] + t[..., 3, 3] + 2) >> 2
    return d0, d1, d2, d3


def _tile_energy(A, ro, co):
    """4x4 haar + downsampled energy (ref: bmc.c:224-270)."""
    t = A[..., ro:ro + 4, co:co + 4]
    d0, d1, d2, d3 = _quads(t)
    x0 = t[..., 0::2, 0::2]
    x1 = t[..., 0::2, 1::2]
    x2 = t[..., 1::2, 0::2]
    x3 = t[..., 1::2, 1::2]
    hh = (x0 - x1 - x2 + x3).abs() >> 1
    sh = ((x0 - x1 + x2 - x3).abs() + hh).sum(dim=(-1, -2), dtype=_I32)
    sv = ((x0 + x1 - x2 - x3).abs() + hh).sum(dim=(-1, -2), dtype=_I32)
    hhl = (d0 - d1 - d2 + d3).abs() >> 1
    slh = (d0 - d1 + d2 - d3).abs() + hhl
    slv = (d0 + d1 - d2 - d3).abs() + hhl
    return sh, sv, slh, slv


def _dsfactor(A, ro, co):
    """Downsampled smoothing factor (ref: bmc.c:193-222)."""
    d0, d1, d2, d3 = _quads(A[..., ro:ro + 4, co:co + 4])
    sh = ((d0 + d1) - (d3 + d2)).abs()
    sv = ((d2 + d1) - (d3 + d0)).abs()
    small = torch.maximum(sh, sv) < 8
    d2b = 255 - d2
    d3b = 255 - d3
    sh2 = (d0 - d1 + d2b - d3b).abs()
    sv2 = (d0 + d1 - d2b - d3b).abs() >> 2
    r = torch.where(sh2 > sv2, (3 * sh2 + sv2 + 2) >> 2,
                    (3 * sv2 + sh2 + 2) >> 2)
    return torch.where(small, 0, r)


def _degrad(A, ro, co, mask):
    """Histogram de-gradient sharpener on the 4x4 tile (ref: bmc.c:272-337).
    The twin's argmax over the 16 bins is the first set bin (0 if none),
    its reversed argmax the last (15 if none)."""
    if not bool(mask.any()):
        return A
    t4 = A[..., ro:ro + 4, co:co + 4]
    v = t4.reshape(t4.shape[:-2] + (16,))
    bins = torch.arange(16, dtype=_I32, device=A.device)
    oh = (v >> 4)[..., :, None] == bins
    hist = oh.sum(dim=-2, dtype=_I32)
    sums = (oh * v[..., :, None]).sum(dim=-2, dtype=_I32)
    has = hist > 0
    lo = torch.where(has, bins, 16).amin(dim=-1)
    lo = torch.where(lo == 16, 0, lo)
    hi = torch.where(has, bins, -1).amax(dim=-1)
    hi = torch.where(hi < 0, 15, hi)
    ok = mask & (lo < hi)

    def at(a, k):
        return a.gather(-1, k[..., None].long())[..., 0]

    hl, hh = at(hist, lo), at(hist, hi)
    alo = torch.div(at(sums, lo), torch.clamp(hl, min=1),
                    rounding_mode="floor")
    ahi = torch.div(at(sums, hi), torch.clamp(hh, min=1),
                    rounding_mode="floor")
    alo = torch.clamp(alo, min=1)[..., None]
    ahi = torch.clamp(ahi, min=1)[..., None]
    mid = (alo + ahi + 1) >> 1
    low = v + tint.divt(hl[..., None] * (alo - v), 16)
    hig = v + tint.divt(hh[..., None] * (ahi - v), 16)
    nv = torch.where(v < mid, low, torch.where(v > mid, hig, v))
    nv = torch.where(ok[..., None], nv, v)
    A[..., ro:ro + 4, co:co + 4] = nv.reshape(t4.shape)
    return A


def _curve_tex(tt):
    """(ref: bmc.c:364-374 via native curve_tex)."""
    return torch.where(tt < 8, (8 - tt) * 8,
                       torch.where(tt > 192, 0, tt - 7))


# ---------------------------------------------------------------------------
# the three filter steps (ref: bmc.c:390-457, :459-602, :604-659).
# A (B, L, wh, ww), pr (B, NP, L), valid/i_arr/j_arr (L,), sc (B, 8).
# ---------------------------------------------------------------------------

def _intra_step(lay, A, pr, valid, i_arr, j_arr, sc):
    fq, fth = sc[:, 0:1], sc[:, 1:2]
    flags = pr[:, 0]
    m0 = valid & ((flags & F_RINGING) == 0)
    sh, sv, _, _ = _tile_energy(A, 4, 4)
    mx = torch.maximum(sh, sv)
    me = m0 & (mx < 256) & (mx > 8)
    ms = (flags & (F_MAINTAIN | F_STABLE)) != 0
    ttd = _dsfactor(A, 4, 4)
    ttd = torch.where((flags & F_STABLE) != 0, (ttd * 5) >> 2, ttd)
    tt = torch.where(ms, ttd, 8)
    tt = tint.divt(tt * 2, 3)
    tt = torch.minimum(torch.clamp((tt * fq) >> 12, min=0), fth)
    tt1 = torch.where(me, tt, 0)
    mh = i_arr >= 1
    mv_ = j_arr >= 1
    ieh = (i_arr * 4) < (lay.pw - 8)
    iev = (j_arr * 4) < (lay.ph - 8)
    no_e = torch.zeros_like(me)
    A = _hfilt(A, 4, 4, no_e, tt1, tt1, me & mh, ieh)
    A = _vfilt(A, 4, 4, no_e, tt1, tt1, me & mv_, iev)
    tt2 = torch.where(sh > sv, 3 * sh + sv, 3 * sv + sh)
    tt2 = _curve_tex(tt2)
    tt2 = 16 + ((tt2 + 2) >> 2)
    tt2 = torch.minimum(torch.clamp((tt2 * fq) >> 12, min=0), fth)
    tt2 = torch.where(me, tt2, 0)
    A = _hfilt(A, 4, 4, no_e, tt2, tt2, me & mh, ieh)
    return _vfilt(A, 4, 4, no_e, tt2, tt2, me & mv_, iev)


def _luma_step(lay, A, pr, valid, i_arr, j_arr, sc):
    fq, fth, dof_s, tmc_s, ish = (sc[:, k:k + 1] for k in range(5))
    thH = torch.clamp((64 * fq) >> 12, 2, 32)
    thL = torch.clamp((32 * fq) >> 12, 2, 32)
    sharpen = (ish * tmc_s) != 0
    dof = dof_s != 0
    bmvx, bmvy, fl, sub, ndx, ndy = (pr[:, k] for k in range(6))
    eh, ev, ehs, evs = (pr[:, k] != 0 for k in range(6, 10))
    skip = ((fl >> K.MV_BIT_SKIP) & 1) != 0
    intra = ((fl >> K.MV_BIT_INTRA) & 1) != 0
    eprm = ((fl >> K.MV_BIT_EPRM) & 1) != 0
    amx = bmvx.abs()
    amy = bmvy.abs()
    mbase = valid & ~skip
    mh = i_arr >= 1
    mv_ = j_arr >= 1
    ieh = (i_arr * 4) < (lay.pw - 8)
    iev = (j_arr * 4) < (lay.ph - 8)
    # intra blocks (filtered regardless of do_filter; ref: bmc.c:529-545)
    subne = sub != K.MASK_ALL_INTRA
    teh = eh | (subne & ehs)
    tev = ev | (subne & evs)
    mi = mbase & intra
    thHv = torch.where(mi, thH, 0)
    thLv = torch.where(mi, thL, 0)
    A = _hfilt(A, 4, 4, teh, thHv, thLv, mi & mh, ieh)
    A = _vfilt(A, 4, 4, tev, thHv, thLv, mi & mv_, iev)
    # inter blocks with neighbour-MV divergence (ref: bmc.c:547-594)
    mdf = mbase & ~intra & dof & ((ndx != 0) | (ndy != 0))
    sh, sv, slh, slv = _tile_energy(A, 4, 4)
    tndc = (ndx + ndy + 1) >> 1
    cdir = (sh < 2 * sv) & (sv < 2 * sh)
    ndx_e = torch.where(cdir & (ndx < amx), ndx >> 1, ndx)
    ndy_e = torch.where(cdir & (ndy < amy), ndy >> 1, ndy)
    shl = torch.where(slh > 128, 0, 128 - slh)
    svl = torch.where(slv > 128, 0, 128 - slv)
    ix = torch.clamp(amx, max=32)
    iy = torch.clamp(amy, max=32)
    ttA = ((sh * (32 - iy) + shl * iy) + 16) >> 5
    ttA = ttA + (((sv * (32 - ix) + svl * ix) + 16) >> 5)
    ttA = (ttA + 1) >> 1
    ttA = torch.where((ndx_e < amy) & (ndy_e < amx), 0, ttA)
    tt = torch.where(cdir, ttA, (sh + sv + 1) >> 1)
    tt = (tt * tndc + 4) >> 3
    tt = (torch.minimum(tt, fth) * fq) >> 12
    addx = (torch.minimum(ndy_e, fth) * fq) >> 12
    addy = (torch.minimum(ndx_e, fth) * fq) >> 12
    bv = (sh > 2 * sv) | (amy > 2 * amx)
    bh_ = ((sv > 2 * sh) | (amx > 2 * amy)) & ~bv
    mboth = ~bv & ~bh_
    A = _hfilt(A, 4, 4, eh | eprm, tt + addx, tt,
               mdf & (bh_ | mboth) & mh, ieh)
    A = _vfilt(A, 4, 4, ev | eprm, tt + addy, tt,
               mdf & (bv | mboth) & mv_, iev)
    # qpel diagonal sharpen (ref: bmc.c:595-601)
    qdiag = (((bmvx & 3) != 0) & ((bmvy & 3) != 0)
             & (((bmvx | bmvy) & 1) != 0))
    msh = mbase & ~intra & sharpen & qdiag & (amx < 8) & (amy < 8)
    return _degrad(A, 4, 4, msh)


def _chroma_step(lay, A, pr, valid, i_arr, j_arr, sc):
    q = sc[:, 0:1]
    ith = torch.clamp((64 * q) >> 12, 2, 32)
    bmvx, bmvy, fl, ndx, ndy = (pr[:, k] for k in range(5))
    skip = ((fl >> K.MV_BIT_SKIP) & 1) != 0
    intra = ((fl >> K.MV_BIT_INTRA) & 1) != 0
    mbase = valid & ~skip
    amx = bmvx.abs()
    amy = bmvy.abs()
    cz = (ndx < amy) & (ndy < amx)
    tx = torch.where(cz, 0, (torch.clamp(ndy, max=64) * q) >> 12)
    ty = torch.where(cz, 0, (torch.clamp(ndx, max=64) * q) >> 12)
    tx = torch.where(intra, ith, tx)
    ty = torch.where(intra, ith, ty)
    pw, ph, bw, bh = lay.pw, lay.ph, lay.tw, lay.th
    x0 = i_arr * bw
    y0 = j_arr * bh
    no_e = torch.zeros_like(mbase)
    ieh = x0 < (pw - 8)
    iev = y0 < (ph - 8)
    ghx = mbase & (x0 >= 4) & (x0 <= pw - 4)
    gvy = mbase & (y0 >= 4) & (y0 <= ph - 4)
    for z in range(0, bh, 4):
        A = _hfilt(A, 4 + z, 4, no_e, tx, tx, ghx & (y0 + z + 4 < ph), ieh)
    for z in range(0, bw, 4):
        A = _vfilt(A, 4, 4 + z, no_e, ty, ty, gvy & (x0 + z + 4 < pw), iev)
    return A


_STEPS = {"intra": _intra_step, "luma": _luma_step, "chroma": _chroma_step}


# ---------------------------------------------------------------------------
# the wavefront: plain version and dispatch
# ---------------------------------------------------------------------------

def _diagonal_lanes(lay, d, device):
    """(i, j, valid) of the L lanes of diagonal d; invalid lanes (past the
    grid) are clipped into it and write nothing."""
    j0 = max(0, (d - (lay.ntx - 1) + 1) >> 1)
    j = j0 + torch.arange(lay.L, dtype=_I32, device=device)
    i = d - 2 * j
    return i, j, (j < lay.nty) & (i >= 0)


def wavefront_filter_plain(kind, lay, plane, props, scal):
    """Plain PyTorch wavefront, in place on plane (B, HP, WP) int32 (the
    visible plane at (mr, mc) inside zero margins). props (B, NP, nty,
    ntx) int32 per-tile properties, scal (B, 8) int32 per-plane scalars.
    Each diagonal gathers every lane's window, runs the step on a copy,
    and adds the masked deltas back — all reads before any write."""
    nb = plane.shape[0]
    dev = plane.device
    flat = plane.view(nb, lay.HP * lay.WP)
    win = ((torch.arange(lay.wh, device=dev) * lay.WP)[:, None]
           + torch.arange(lay.ww, device=dev)[None, :])
    step = _STEPS[kind]
    for d in range(lay.nd):
        i, j, valid = _diagonal_lanes(lay, d, dev)
        ic = torch.clamp(i, 0, lay.ntx - 1).long()
        jc = torch.clamp(j, 0, lay.nty - 1).long()
        base = (lay.mr - 4 + jc * lay.th) * lay.WP + (lay.mc - 4
                                                       + ic * lay.tw)
        idx = (base[:, None, None] + win).reshape(-1)
        A = flat[:, idx].reshape(nb, lay.L, lay.wh, lay.ww)
        A2 = step(lay, A.clone(), props[:, :, jc, ic], valid, i, j, scal)
        delta = torch.where(valid[:, None, None], A2 - A, 0)
        flat.index_add_(1, idx, delta.reshape(nb, -1))
    return plane


def wavefront_filter(kind, lay, plane, props, scal):
    """Run the in-loop filter wavefront of `kind` in place on plane (B, HP,
    WP) int32: the CUDA kernel (csrc/wavefront_filter.cu) for a CUDA
    tensor, the plain version for a CPU tensor. A CUDA tensor gets the
    kernel or an error; the kernel holds the plane as uint8, so its values
    must lie in [0, 255], as every codec plane's do (the filters keep them
    there). Each kernel launch counts as `launch.wavefront_filter.<kind>`
    (utils/trace)."""
    if kind not in KINDS:
        raise ValueError("unknown filter kind %r" % (kind,))
    nb = plane.shape[0]
    shapes = {"plane": (nb, lay.HP, lay.WP),
              "props": (nb, _NPROPS[kind], lay.nty, lay.ntx),
              "scal": (nb, 8)}
    for name, t in (("plane", plane), ("props", props), ("scal", scal)):
        if t.dtype != _I32 or tuple(t.shape) != shapes[name]:
            raise ValueError("%s must be int32 %s, got %s %s"
                             % (name, shapes[name], t.dtype,
                                tuple(t.shape)))
        if t.device != plane.device:
            raise ValueError("%s is on %s, plane on %s"
                             % (name, t.device, plane.device))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if plane.device.type == "cpu":
        return wavefront_filter_plain(kind, lay, plane, props, scal)
    if plane.device.type != "cuda":
        raise ValueError("no wavefront filter for device %s" % plane.device)
    from . import _kernels
    _kernels.wavefront_filter(KINDS.index(kind), lay, plane, props, scal)
    trace.count("launch.wavefront_filter." + kind)
    return plane


# ---------------------------------------------------------------------------
# the three filters: uint8 planes (..., ph, pw) in and out
# ---------------------------------------------------------------------------

def _lead(t, lead):
    """Broadcast t, a single value or one whose dimensions are leading
    dimensions of the planes from the left (a lane's value over its U and
    V planes), to `lead`."""
    if t.numel() == 1:
        t = t.reshape(())
    return t.reshape(t.shape + (1,) * (len(lead) - t.dim())).expand(lead)


def _scalars(lead, device, *vals):
    """(nb, 8) int32 for planes with leading dimensions `lead` (nb their
    product): each value (int, numpy int, or a tensor over the first of
    those dimensions, e.g. one per lane of (L, 2) stacked U and V planes)
    broadcast per plane, zero-padded to 8 columns. An int is a fill, a
    tensor on the planes' device a copy: neither waits for the device, and
    a value that changes from frame to frame is a tensor, so a captured
    CUDA graph (codec/devsteps) reads it rather than baking it in."""
    nb = int(np.prod(lead, dtype=np.int64))
    sc = torch.zeros((nb, 8), dtype=_I32, device=device)
    for k, v in enumerate(vals):
        if isinstance(v, torch.Tensor):
            sc[:, k] = _lead(v.to(_I32), lead).reshape(-1)
        else:
            sc[:, k].fill_(int(v))
    return sc


def _run(kind, lay, vis_u8, props, *scal):
    """Pad the batch of visible planes into the layout, run the wavefront,
    crop and cast back to uint8. props (..., NP, nty, ntx) and the
    scalars broadcast over the planes' leading dimensions from the left
    (U and V of a lane share its motion field and q)."""
    lead = vis_u8.shape[:-2]
    vis = vis_u8.reshape((-1, lay.ph, lay.pw))
    nb = vis.shape[0]
    plane = torch.zeros((nb, lay.HP, lay.WP), dtype=_I32, device=vis.device)
    plane[:, lay.mr:lay.mr + lay.ph, lay.mc:lay.mc + lay.pw] = vis
    pl = props.shape[:-3]
    props = props.to(_I32).reshape(
        pl + (1,) * (len(lead) - len(pl)) + props.shape[-3:]).expand(
        lead + props.shape[-3:]).reshape((nb,) + props.shape[-3:]
                                         ).contiguous()
    wavefront_filter(kind, lay, plane, props,
                     _scalars(lead, vis.device, *scal))
    out = plane[:, lay.mr:lay.mr + lay.ph, lay.mc:lay.mc + lay.pw]
    return out.to(torch.uint8).reshape(vis_u8.shape)


def _tile_index(pw, ph, nbh, nbv):
    """The static tile->block maps (fy, fx) of _tile_maps."""
    _, _, fx, fy = _tile_maps(pw, ph, nbh, nbv)
    return fy, fx


def _edge_table(ntx, nty, blk_w, blk_h):
    """The luma filter's static per-tile block-edge flags (4, nty, ntx)
    int32: tile on a block's left / top edge, on a half block's left /
    top edge."""
    edgeh = ((np.arange(ntx) * 4) % blk_w) == 0
    edgev = ((np.arange(nty) * 4) % blk_h) == 0
    edgehs = ((np.arange(ntx) * 4) % (blk_w // 2)) == 0
    edgevs = ((np.arange(nty) * 4) % (blk_h // 2)) == 0
    return np.stack([np.broadcast_to(a[None, :] if ax else a[:, None],
                                     (nty, ntx))
                     for a, ax in ((edgeh, 1), (edgev, 0), (edgehs, 1),
                                   (edgevs, 0))]).astype(np.int32)


def _tile_props(grids, pw, ph, nbh, nbv):
    """(..., NP, nbv, nbh) per-block grids -> (..., NP, nty, ntx) per tile
    through the static tile->block maps (device tables, built once per
    device and geometry)."""
    fy, fx = tint.on_device(grids.device, _tile_index, pw, ph, nbh, nbv)
    return grids[..., fy[:, None], fx[None, :]]


def intra_filter_graph(pw, ph, nbh, nbv, vis_u8, bd_grid, fq, fthresh):
    """Intra dering filter on visible planes (..., ph, pw) uint8 with
    blockdata (..., nbv, nbh); fq/fthresh per plane (ref: bmc.c:390-457).
    fthresh is the caller's fthresh * do_filter."""
    ntx, nty, _, _ = _tile_maps(pw, ph, nbh, nbv)
    if ntx <= 0 or nty <= 0:
        return vis_u8
    lay = _layout(pw, ph, 4, 4, ntx, nty)
    props = _tile_props(bd_grid.to(_I32)[..., None, :, :], pw, ph, nbh, nbv)
    return _run("intra", lay, vis_u8, props, fq, fthresh)


def luma_filter_graph(pw, ph, nbh, nbv, blk_w, blk_h, inter_sharpen,
                      vis_u8, mvx, mvy, flags, submask,
                      fq, fthresh, do_filter, tmc):
    """Inter luma filter (ref: bmc.c:459-602). mvx/mvy/flags/submask:
    (..., nbv, nbh) int32 grids; fq/fthresh/do_filter/tmc per plane
    (ints, or tensors over the leading dimensions)."""
    ntx, nty, _, _ = _tile_maps(pw, ph, nbh, nbv)
    if ntx <= 0 or nty <= 0:
        return vis_u8
    lay = _layout(pw, ph, 4, 4, ntx, nty)
    ndx_g, ndy_g = _neighbordif2_grids(mvx, mvy, flags)
    bprops = torch.stack([mvx, mvy, flags, submask, ndx_g, ndy_g], dim=-3)
    props_bt = _tile_props(bprops.to(_I32), pw, ph, nbh, nbv)
    st = tint.on_device(vis_u8.device, _edge_table, ntx, nty, blk_w, blk_h)
    props = torch.cat([props_bt,
                       st.expand(props_bt.shape[:-3] + st.shape)], dim=-3)
    return _run("luma", lay, vis_u8, props, fq, fthresh, do_filter, tmc,
                int(inter_sharpen))


def chroma_filter_graph(pw, ph, nbh, nbv, bw, bh, vis_u8,
                        mvx, mvy, flags, q):
    """Inter chroma filter, block-granular (ref: bmc.c:604-659). bw/bh:
    chroma block pixel dims. vis_u8 may stack planes that share the motion
    grids and q into one launch: U and V, (2, ph, pw) with (nbv, nbh)
    grids, or the U and V of L lanes, (L, 2, ph, pw) with (L, nbv, nbh)
    grids and q (L,)."""
    if nbh <= 0 or nbv <= 0 or pw < 8 or ph < 8:
        return vis_u8
    lay = _layout(pw, ph, bw, bh, nbh, nbv)
    ndx_g, ndy_g = _neighbordif2_grids(mvx, mvy, flags)
    props = torch.stack([mvx, mvy, flags, ndx_g, ndy_g], dim=-3).to(_I32)
    return _run("chroma", lay, vis_u8, props, q)
