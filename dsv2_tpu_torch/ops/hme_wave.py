"""Wavefront motion estimation: the whole pyramid search as integer torch
ops, the lanes of each anti-diagonal searched at once.

Port of the XLA form of `dsv2_tpu/ops/hme_wave.py` (ref: src/hme.c). The
reference's raster-order dependencies (spatial candidates and the MV-cost
median predictor read the left/top/top-left neighbours; ref:
hme.c:1202-1228, dsv.c:373-400) only couple a block to earlier
anti-diagonals, so each level runs as a Python loop over diagonals with
every block of a diagonal searched at once. The twin's vmap over a
diagonal is a leading lane dimension written out: a per-block scalar is
an (L,) tensor, a plane window an (L, h, w) tensor, and the candidate
slots, refine probes and quadrants add one more dimension before the
window's. Candidate lists are fixed-width with validity masks; the best
candidate is the first strict minimum in slot order, exactly like the
serial code. Partial edge blocks use masked metrics over static windows.

This is the plain version of the motion-search kernels: ops/hme_gpu runs
it for CPU tensors, and csrc/hme_search.cu is held to it on the card.
Integer only: the twin's int32 values are int32 tensors (torch wraps like
XLA), its uint32 values are int64 tensors masked to 32 bits (torch has
no uint32 arithmetic), C-truncating division is `tint.divt` and the
twin's `//` is floor division. The twin's Pallas hooks and its
phase-plane qpsad (a TPU layout of the same sums) are not carried over.
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as K
from ..core import intmath as im
from ..core.frame import B
from . import tint
from .tint import on_device

U32 = 0xFFFFFFFF
I32MAX = 0x7FFFFFFF
RECT = np.array([[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1],
                 [-1, -1], [1, -1], [-1, 1], [1, 1]], dtype=np.int32)
_PTS = np.array([[0, 0], [-2, 0], [2, 0], [0, -2], [0, 2],
                 [-2, -2], [2, 2], [2, -2], [-2, 2]], dtype=np.int32)
SPD = 17           # subpel probe grid: full-pel samples per side
_I32 = torch.int32
_I64 = torch.int64
_QUADS = ((0, 0, K.MASK_INTRA00), (1, 0, K.MASK_INTRA01),
          (0, 1, K.MASK_INTRA10), (1, 1, K.MASK_INTRA11))


# ---------------------------------------------------------------------------
# uint32 helpers: a uint32 value rides in an int64 tensor, masked
# ---------------------------------------------------------------------------

def u32(x):
    """The uint32 reading of an int32 (or int64) tensor, as int64."""
    return x.to(_I64) & U32


def s32(x):
    """A uint32 value (int64 tensor) reinterpreted as int32."""
    return (((x & U32) ^ 0x80000000) - 0x80000000).to(_I32)


def usum(x):
    """Sum over the last two dims modulo 2**32, as a uint32 (int64)."""
    return x.to(_I64).sum(dim=(-1, -2)) & U32


def udiv(a, b):
    """uint32 a // b (both int64, b >= 1)."""
    return torch.div(a, b, rounding_mode="floor")


def isqrt_u32(n):
    """Integer sqrt (floor) of a uint32 value (int64 tensor); int32
    (ref: hme.c:100-124)."""
    res = torch.zeros_like(n)
    rem = n
    for k in range(16):
        pos = 1 << (30 - 2 * k)
        dif = res + pos
        take = rem >= dif
        rem = torch.where(take, rem - dif, rem)
        res = (res >> 1) + take.to(_I64) * pos
    return res.to(_I32)


def _fdiv(a, b):
    """The twin's `//` (floor) on int32 tensors."""
    return torch.div(a, b, rounding_mode="floor")


def _e(t, n=2):
    """A per-block scalar broadcast against windows: n trailing dims."""
    return t.reshape(t.shape + (1,) * n)


def seg_bits(v):
    """(ref: dsv.c:334-354)."""
    return tint.ilog2(v.abs() + 1) * 2 + 2


def mv_cost(px, py, blk_w, blk_h, vid_w, vid_h, mx, my, q, sqr):
    """(ref: dsv.c:356-371 + hme.c:354-366). px/py = median pred; q a
    Python int. int32 arithmetic wraps like the reference's C ints."""
    bits = seg_bits(mx - px) + seg_bits(my - py)
    b2sr = (256 * ((q * q) >> K.MAX_QP_BITS) * (blk_w * blk_h)) // (
        vid_w * vid_h)
    bits = bits + (bits * b2sr >> 7)
    if sqr:
        bits = bits * bits
    cost = torch.clamp(bits, max=1 << 19)
    if sqr:
        return cost * ((q * q) >> K.MAX_QP_BITS) >> (K.MAX_QP_BITS - 2)
    return 3 * cost * q >> K.MAX_QP_BITS


def pred3(left, top, topleft):
    dif = left + top - topleft
    return torch.where((dif - left).abs() < (dif - top).abs(), left, top)


def _rd(f, x, y):
    """f[clip(y), clip(x)] per lane."""
    return f[torch.clamp(y, 0, f.shape[0] - 1).long(),
             torch.clamp(x, 0, f.shape[1] - 1).long()]


def movec_pred(fx, fy, i, j):
    """Median predictor gathers with zero defaults (ref: dsv.c:373-400)."""
    def g(f, x, y, ok):
        return torch.where(ok, _rd(f, x, y), 0)
    lx, ly = g(fx, i - 1, j, i > 0), g(fy, i - 1, j, i > 0)
    tx, ty = g(fx, i, j - 1, j > 0), g(fy, i, j - 1, j > 0)
    c = (i > 0) & (j > 0)
    cx, cy = g(fx, i - 1, j - 1, c), g(fy, i - 1, j - 1, c)
    return pred3(lx, tx, cx), pred3(ly, ty, cy)


# ---------------------------------------------------------------------------
# masked metrics over static (h, w) windows
# ---------------------------------------------------------------------------

def window(plane, x, y, h, w):
    """(..., h, w) int32 windows of a bordered uint8 plane at visible
    coords (x, y) (int32 tensors of shape ...): the twin's dynamic_slice,
    whose start is clamped so the window lies inside the plane."""
    H, W = plane.shape
    dev = plane.device
    y0 = torch.clamp(y + B, 0, H - h).long()
    x0 = torch.clamp(x + B, 0, W - w).long()
    rows = y0[..., None] + torch.arange(h, device=dev)
    cols = x0[..., None] + torch.arange(w, device=dev)
    return plane[rows[..., :, None], cols[..., None, :]].to(_I32)


def _mask(h, w, bw, bh, dev, dx=0, dy=0):
    """(..., h, w) mask of the window cells (r, c) with c + dx < bw and
    r + dy < bh."""
    cc = torch.arange(w, device=dev) + dx
    rr = torch.arange(h, device=dev)[:, None] + dy
    return (cc < _e(bw)) & (rr < _e(bh))


def masked_sse(a, b, bw, bh):
    """(ref: hme.c:198-242); a/b windows, bw/bh per block."""
    m = _mask(a.shape[-2], a.shape[-1], bw, bh, a.device)
    d = torch.where(m, a - b, 0)
    acc = s32(usum(d * d))
    return torch.where((bw == 0) | (bh == 0), I32MAX, acc)


def _uavg4(a, b, c, d):
    return (a + b + c + d + 2) >> 2


def _quads(x):
    """The reference's 2x2-quadrant decomposition of (..., h, w) windows
    (h, w even): a1 = X[0::2, 0::2], a2 = X[0::2, 1::2], a3 = X[1::2, 0::2],
    a4 = X[1::2, 1::2]."""
    return (x[..., 0::2, 0::2], x[..., 0::2, 1::2], x[..., 1::2, 0::2],
            x[..., 1::2, 1::2])


def _tex(q):
    a1, a2, a3, a4 = q
    return _uavg4((a1 - a2).abs(), (a2 - a3).abs(), (a3 - a4).abs(),
                  (a4 - a1).abs())


def _qmask(a, bw, bh):
    """Quad cells (r, c) with r < bh // 2 and c < bw // 2."""
    return _mask(a.shape[-2] // 2, a.shape[-1] // 2, _fdiv(bw, 2),
                 _fdiv(bh, 2), a.device)


def masked_metr_acc(a, b, bw, bh, ew, tw, aw):
    """(ref: hme.c:126-196); uint32 (int64). ew/tw/aw per block."""
    qa, qb = _quads(a), _quads(b)
    se = _uavg4(*((x - y).abs() for x, y in zip(qa, qb)))
    ta, tb = _tex(qa), _tex(qb)
    s0, s1 = _uavg4(*qa), _uavg4(*qb)
    t = (((se * se) << _e(ew)) + (((ta - tb) ** 2) << _e(tw))
         + (((s0 - s1) ** 2) << _e(aw)))
    return usum(torch.where(_qmask(a, bw, bh), t, 0))


def metric_return(acc, bw, bh):
    return _fdiv(isqrt_u32(acc) * (bw * bh),
                 torch.clamp((bw + bh + 1) >> 1, min=1))


def masked_metr(a, b, bw, bh, ew, tw, aw):
    r = metric_return(masked_metr_acc(a, b, bw, bh, ew, tw, aw), bw, bh)
    return torch.where((bw == 0) | (bh == 0), I32MAX, r)


# ---------------------------------------------------------------------------
# block features (ref: hme.c:492-749) on masked static windows
# ---------------------------------------------------------------------------

def _msum(x, m):
    return torch.where(m, x, 0).sum(dim=(-1, -2), dtype=_I32)


def block_feat_detail(a, bw, bh):
    """(detail, avg, var, tex) over the masked window."""
    h, w = a.shape[-2:]
    dev = a.device
    m = _mask(h, w, bw, bh, dev)
    s = _msum(a, m)
    sh = _msum((a[..., :, 1:] - a[..., :, :-1]).abs(),
               _mask(h, w - 1, bw, bh, dev, dx=1))
    sv = _msum((a[..., 1:, :] - a[..., :-1, :]).abs(),
               _mask(h - 1, w, bw, bh, dev, dy=1))
    avg = _fdiv(s, torch.clamp(bw * bh, min=1))
    var = _msum((a - _e(avg)).abs(), m)
    tex = torch.maximum(sh, sv) - (var >> 1)
    detail = (var >> 1) + torch.clamp(tex, min=0)
    return detail, avg, var, torch.maximum(sh, sv)


def block_feat_qtex(a, bw, bh):
    """quant_tex (ref: hme.c:586-617)."""
    h, w = a.shape[-2:]
    dev = a.device
    q = a >> 4
    dh = q[..., :, :-1] - q[..., :, 1:]
    sh = usum(torch.where(_mask(h, w - 1, bw, bh, dev, dx=1), dh * dh, 0))
    dv = q[..., 1:, :] - q[..., :-1, :]
    sv = usum(torch.where(_mask(h - 1, w, bw, bh, dev, dy=1), dv * dv, 0))
    return _fdiv(isqrt_u32(torch.maximum(sh, sv)),
                 torch.clamp((bw + bh + 1) >> 1, min=1))


def _hist16(idx, m):
    """(..., 16) int32 histogram of idx values in 0..15 over mask m."""
    bins = torch.arange(16, device=idx.device)
    hit = (idx[..., None] == bins) & m[..., None]
    return hit.sum(dim=(-3, -2), dtype=_I32)


def block_feat_hvar(a, bw, bh, avg):
    """(ref: hme.c:711-749)."""
    h, w = a.shape[-2:]
    m = _mask(h, w, bw, bh, a.device)
    area = torch.clamp(bw * bh, min=1)
    q16 = _fdiv(torch.full_like(avg, 8 << 16), torch.clamp(avg, min=1))
    hi = torch.clamp((a * _e(q16)) >> 16, 0, 15)
    hist = _hist16(hi, m)
    hm = _fdiv(hist.sum(dim=-1, dtype=_I32), 16)
    hv = (hist - hm[..., None]).to(_I64).pow(2).sum(dim=-1) & U32
    return s32(udiv((hv * 256) & U32, u32(16 * area * area)))


def block_feat_peaks(a, bw, bh, avg):
    """(ref: hme.c:624-692)."""
    q16 = _fdiv(torch.full_like(avg, 8 << 16), torch.clamp(avg, min=1))
    ds = _uavg4(*_quads(a))
    hi = torch.clamp((ds * _e(q16)) >> 16, max=15)
    hist = _hist16(hi, _qmask(a, bw, bh))
    pavg = _fdiv(hist.sum(dim=-1, dtype=_I32), 16)[..., None]
    maxv = (hist.max(dim=-1).values >> 2)[..., None]
    neg1 = torch.full_like(hist[..., :1], -1)
    left = torch.cat([neg1, hist[..., :-1]], dim=-1)
    right = torch.cat([hist[..., 1:], neg1], dim=-1)
    pk = (hist > left) & (hist > right) & ((hist > maxv) | (hist > pavg))
    return pk.sum(dim=-1, dtype=_I32)


def masked_avg(a, bw, bh):
    m = _mask(a.shape[-2], a.shape[-1], bw, bh, a.device)
    return _fdiv(_msum(a, m), torch.clamp(bw * bh, min=1))


# ---------------------------------------------------------------------------
# subpel probe grid (ref: hme.c:787-837) on a static 21x21 window
# ---------------------------------------------------------------------------

def _ilv(a, b, dim):
    """[a0, b0, a1, b1, ...] along dim (-1 or -2)."""
    st = torch.stack([a, b], dim=dim)
    sh = list(a.shape)
    sh[dim] *= 2
    return st.reshape(sh)


def qpel_grid(refwin):
    """refwin: (..., 21, 21) int32 whose (1, 1) element is the probe
    origin; returns the (..., 68, 68) quarter-pel grid."""
    r = refwin
    S = SPD

    def hpf(a, b, c, d):
        return 5 * (b + c) - (a + d)

    hbuf = hpf(r[..., :, 0:S], r[..., :, 1:S + 1], r[..., :, 2:S + 2],
               r[..., :, 3:S + 3])
    fr = r[..., 1:1 + S, 1:1 + S]
    hh = torch.clamp((hpf(r[..., 1:1 + S, 0:S], fr, r[..., 1:1 + S, 2:2 + S],
                          r[..., 1:1 + S, 3:3 + S]) + 4) >> 3, 0, 255)
    vv = torch.clamp((hpf(r[..., 0:S, 1:1 + S], fr, r[..., 2:2 + S, 1:1 + S],
                          r[..., 3:3 + S, 1:1 + S]) + 4) >> 3, 0, 255)
    dg = torch.clamp((hpf(hbuf[..., 0:S, :], hbuf[..., 1:1 + S, :],
                          hbuf[..., 2:2 + S, :], hbuf[..., 3:3 + S, :])
                      + 32) >> 6, 0, 255)
    core = _ilv(_ilv(fr, hh, -1), _ilv(vv, dg, -1), -2)     # (..., 34, 34)
    hg = torch.nn.functional.pad(core, (0, 1, 0, 1))        # zero row/col
    n = 2 * S
    h0, hx = hg[..., :n, :n], hg[..., :n, 1:n + 1]
    hy, hxy = hg[..., 1:n + 1, :n], hg[..., 1:n + 1, 1:n + 1]
    return _ilv(_ilv(h0, (h0 + hx + 1) >> 1, -1),
                _ilv((h0 + hy + 1) >> 1, _uavg4(h0, hx, hy, hxy), -1), -2)


def qpsad(srcsp, q, t0, t1, ew, tw, aw):
    """(ref: hme.c:244-269). srcsp (L, 16, 16), q (L, 68, 68); t0/t1
    (L, P) probe offsets in [-3, 3]: compares srcsp with q[4 + t1::4,
    4 + t0::4]. Returns (L, P) int32; ew/tw/aw (L,)."""
    dev = q.device
    k = 4 * torch.arange(16, device=dev)
    rows = (4 + t1)[..., None] + k
    cols = (4 + t0)[..., None] + k
    lane = torch.arange(q.shape[0], device=dev)[:, None, None, None]
    sub = q[lane, rows[..., :, None].long(), cols[..., None, :].long()]
    n16 = torch.full_like(t0, 16)
    acc = masked_metr_acc(srcsp[:, None], sub, n16, n16, ew[:, None],
                          tw[:, None], aw[:, None])
    return metric_return(acc, n16, n16)


# ---------------------------------------------------------------------------
# err_intra (ref: hme.c:839-889) with exact unsigned wraparound
# ---------------------------------------------------------------------------

def err_intra(a, b, bw, bh, avg_sb, avg_src, ratio):
    """psy = (0, 1, 2) as at the call site (ref: hme.c:917-919). Returns
    (intra_sb, intra_src, inter) as uint32 (int64)."""
    qm = _qmask(a, bw, bh)
    ratio_u = _e(u32(ratio))
    qa, qb = _quads(a), _quads(b)
    s0, s1 = _uavg4(*qa), _uavg4(*qb)
    ta, tb = _tex(qa), _tex(qb)
    ae = _uavg4(*((x - y).abs() for x, y in zip(qa, qb)))
    inter = ((u32(ae * ae) * ratio_u) & U32) >> 5
    inter = inter + u32(((ta - tb) ** 2) << 1) + u32(((s0 - s1) ** 2) << 2)
    inter = usum(torch.where(qm, inter & U32, 0))

    def intra_term(avgv):
        av = _e(avgv)
        aev = _uavg4(*((x - av).abs() for x in qa))
        t = (u32(aev * aev) + u32((ta * ta) << 1)
             + u32(((s0 - av) ** 2) << 3)) & U32
        return usum(torch.where(qm, t, 0))

    return (intra_term(avg_sb), intra_term(avg_src),
            ((inter * u32(ratio)) & U32) >> 5)


# ---------------------------------------------------------------------------
# per-level wavefront search
# ---------------------------------------------------------------------------

class WaveCfg(NamedTuple):
    nbh: int
    nbv: int
    blk_w: int
    blk_h: int
    vid_w: int
    vid_h: int
    subsamp: int
    effort: int
    lossless: bool
    pyramid_levels: int
    has_tmv: bool
    skip_thresh_neg: bool   # skip_block_thresh < 0 (disables skip test)
    dims: tuple             # per-level (w, h) of the luma planes

    @property
    def psyf_all(self):
        from . import hzcc
        return hzcc.spatial_psy_factor(self, -1)


def invalid_block(bx, by, bw, bh, pad, fw, fh):
    """(ref: hme.c:426-434). fw/fh = frame dims at the level."""
    return ((bx - pad < -B) | (by - pad < -B)
            | (bx + bw + pad >= fw + B) | (by + bh + pad >= fh + B))


def _refine_loop(cfg, level, src_w, ref_pl, bx, by, bw, bh, psy,
                 bestx, besty, best, qthresh, px, py, quant, fw, fh, active):
    """Greedy walk with retry (ref: hme.c:1300-1370) for every lane at
    once: a batched while loop whose lanes stop one by one; a lane that
    is done (or not `active`) keeps its state. Returns (bestx, besty,
    best, good)."""
    step = 1 << level
    ew, tw, aw = psy
    mI = I32MAX

    def probe(tvx, tvy):
        """(raw, raw + cost) at offsets (L, P)."""
        rw = window(ref_pl, bx[:, None] + tvx, by[:, None] + tvy,
                    cfg.blk_h, cfg.blk_w)
        args = (src_w[:, None], rw, bw[:, None], bh[:, None])
        if level > 1:
            raw = masked_sse(*args)
        else:
            raw = masked_metr(*args, ew[:, None], tw[:, None], aw[:, None])
        cost = mv_cost(px[:, None], py[:, None], cfg.blk_w, cfg.blk_h,
                       cfg.vid_w, cfg.vid_h, tvx * step * 4, tvy * step * 4,
                       quant, 1 if level > 1 else 0)
        return raw, raw + cost

    full = torch.full_like(bestx, mI)
    metr = [full, full, full, full]
    good = torch.zeros_like(active)
    done = ~active
    rect = torch.as_tensor(RECT[:5], device=bx.device)
    while not bool(done.all()):
        act = ~done
        bx0, by0 = bestx, besty
        tvx5 = bx0[:, None] + rect[:, 0]
        tvy5 = by0[:, None] + rect[:, 1]
        raw5, sc5 = probe(tvx5, tvy5)
        nbx, nby, nbest, ngood, ndone = bestx, besty, best, good, done
        nmetr = list(metr)
        improved = torch.zeros_like(done)
        for k in range(5):
            tvx, tvy = tvx5[:, k], tvy5[:, k]
            inval = invalid_block(bx + tvx, by + tvy, bw, bh, 0, fw, fh)
            do = ~improved & ~inval
            sc_raw = torch.where(do, raw5[:, k], mI)
            sc = torch.where(do, sc5[:, k], mI)
            if 1 <= k <= 4:
                nmetr[k - 1] = torch.where(do, sc_raw, nmetr[k - 1])
            if level == 0:
                ge = do & (tvx == 0) & (tvy == 0) & (sc_raw <= qthresh)
            else:
                ge = torch.zeros_like(do)
            better = do & ~ge & (nbest > sc)
            nbx = torch.where(ge | better, tvx, nbx)
            nby = torch.where(ge | better, tvy, nby)
            nbest = torch.where(ge, sc_raw, torch.where(better, sc, nbest))
            ngood = ngood | ge
            ndone = ndone | ge
            improved = improved | better | ge
        m1, m2, m3, m4 = nmetr
        # diagonal probe only when the 5-point pass had no improvement
        tvx = nbx + torch.where(m1 <= m2, 1, -1).to(_I32)
        tvy = nby + torch.where(m3 <= m4, 1, -1).to(_I32)
        inval = invalid_block(bx + tvx, by + tvy, bw, bh, 0, fw, fh)
        do = ~improved & ~ndone
        _, sc = probe(tvx[:, None], tvy[:, None])
        sc = torch.where(do & ~inval, sc[:, 0], mI)
        better = do & ~inval & (nbest > sc)
        nbx = torch.where(better, tvx, nbx)
        nby = torch.where(better, tvy, nby)
        nbest = torch.where(better, sc, nbest)
        ndone = ndone | (do & ~better)
        bestx = torch.where(act, nbx, bestx)
        besty = torch.where(act, nby, besty)
        best = torch.where(act, nbest, best)
        good = torch.where(act, ngood, good)
        metr = [torch.where(act, n, o) for n, o in zip(nmetr, metr)]
        done = torch.where(act, ndone, done)
    return bestx, besty, best, good


def gather_ctx(cfg, level, carry, parent_x, parent_y, tmv_x, tmv_y, i, j):
    """Every grid read the blocks (i, j) (int32 (L,)) need, gathered up
    front: median predictor, spatial/temporal/parent candidate values,
    left/top neighbour vectors for neighbordif (ref: hme.c:1202-1298)."""
    fx, fy, fskip = carry["fx"], carry["fy"], carry["fskip"]
    step = 1 << level
    g = {"pred": movec_pred(fx, fy, i, j)}
    spat = []
    for dx_, dy_ in ((-1, 0), (0, -1), (-1, -1)):
        xi = i + dx_ * step
        yj = j + dy_ * step
        ok = (xi >= 0) & (yj >= 0)
        spat.append((torch.where(ok, _rd(fx, xi, yj), 0),
                     torch.where(ok, _rd(fy, xi, yj), 0), ok))
    g["spat"] = tuple(spat)

    def ring(fx_, fy_, pts, ci, cj):
        out = []
        for n in range(9):
            tx = ci + int(pts[n, 0]) * step
            ty = cj + int(pts[n, 1]) * step
            ok = (tx >= 0) & (tx < cfg.nbh) & (ty >= 0) & (ty < cfg.nbv)
            out.append((torch.where(ok, _rd(fx_, tx, ty), 0),
                        torch.where(ok, _rd(fy_, tx, ty), 0), ok))
        return tuple(out)

    if level < cfg.pyramid_levels:
        pmask = ~((step << 1) - 1)
        g["par"] = ring(parent_x, parent_y, _PTS, i & pmask, j & pmask)
    if cfg.has_tmv:
        g["tmv"] = ring(tmv_x, tmv_y, RECT, i, j)
        g["tmv_c"] = (_rd(tmv_x, i, j), _rd(tmv_y, i, j))
    g["nbr"] = tuple((_rd(fx, xi, yj), _rd(fy, xi, yj), _rd(fskip, xi, yj),
                      ok)
                     for xi, yj, ok in ((i - 1, j, i > 0),
                                        (i, j - 1, j > 0)))
    return g


def _block_search(cfg, level, g, srcl, refl, ogrl, gx, gy, quant, i, j,
                  lane_valid):
    """Candidate search + refine for the blocks (i, j). g = gather_ctx
    output. Returns a dict of per-block results (level-0 decisions happen
    in _level0_decide) (ref: hme.c:1413-1630)."""
    step = 1 << level
    fw, fh = cfg.dims[level]
    y_w, y_h = cfg.blk_w, cfg.blk_h
    bx = (i * y_w) >> level
    by = (j * y_h) >> level
    valid = lane_valid & (bx < fw) & (by < fh)
    bw = torch.clamp(fw - bx, 0, y_w)
    bh = torch.clamp(fh - by, 0, y_h)
    src_w = window(srcl, bx, by, y_h, y_w)
    zero = torch.zeros_like(i)

    # psy weights + motion bias (ref: hme.c:1424-1481)
    motion_bias = zero + y_w * y_h
    var_src = zero
    avg_src = zero
    ew, tw, aw = zero + 2, zero + 1, zero
    if level <= 1:
        detail, avg_src, _, _ = block_feat_detail(src_w, bw, bh)
        var_src = detail
        tvar = var_src + ((var_src >> 10) ** 2)
        tvar = tint.divt(8 * tvar * quant >> 9, torch.clamp(bw * bh, min=1))
        hvar = block_feat_hvar(src_w, bw, bh, avg_src)
        qtex = block_feat_qtex(src_w, bw, bh)
        npeaks = block_feat_peaks(src_w, bw, bh, avg_src)
        motion_bias = torch.where(
            tvar != 0, motion_bias + tvar * (hvar - qtex) * npeaks,
            motion_bias)
        motion_bias = _fdiv(torch.clamp(motion_bias, min=0),
                            2 + gx.abs() + gy.abs())
        smooth = var_src <= (8 * bw * bh * quant >> 9)
        motion_bias = torch.where(smooth, 0, motion_bias)
        ew = torch.where(smooth, 2, 1).to(_I32)
        tw = torch.where(smooth, 1, 2).to(_I32)
        aw = torch.where(smooth, 2, 1).to(_I32)
        aw = torch.where(var_src > 24 * bw * bh, 0, aw)

    # ---- candidates (ref: hme.c:1443-1528), in slot order ----
    yes = torch.ones_like(valid)
    lax_, lay_ = zero, zero
    cands = [(zero, zero, yes)]
    if level < cfg.pyramid_levels:
        par = g["par"]
        pok_n = [p[2].to(_I32) for p in par]
        nd1 = torch.clamp(sum(pok_n), min=1)
        lax0 = tint.divt(sum(p[0] for p in par), nd1)
        lay0 = tint.divt(sum(p[1] for p in par), nd1)
        dists = [torch.where(p[2], (p[0] - lax0) ** 2 + (p[1] - lay0) ** 2, 0)
                 for p in par]
        avgd = _fdiv(sum(dists), nd1)
        ssd = sum(torch.where(p[2], (d - avgd) ** 2, 0)
                  for p, d in zip(par, dists))
        thresh = avgd + tint.isqrt_u32(tint.divt(ssd, nd1))
        inls = [p[2] & (d <= thresh) for p, d in zip(par, dists)]
        nl = torch.clamp(sum(il.to(_I32) for il in inls), min=1)
        lax_ = tint.divt(sum(torch.where(il, p[0], 0)
                             for p, il in zip(par, inls)), nl)
        lay_ = tint.divt(sum(torch.where(il, p[1], 0)
                             for p, il in zip(par, inls)), nl)
        cands.append((lax_, lay_, yes))                          # slot 1
        if level == 0:
            ppx, ppy = g["pred"]
            cands.append((tint.sar_r(ppx, 2), tint.sar_r(ppy, 2), yes))
        for vx, vy, ok in g["spat"]:                             # slots 3-5
            cands.append((tint.sar_r(vx, 2), tint.sar_r(vy, 2), ok))
        if cfg.has_tmv:
            for tvx, tvy, tok in g["tmv"]:                       # slots 6-14
                cands.append((tint.sar_r(tvx, 2), tint.sar_r(tvy, 2), tok))
        cands.append((zero + gx, zero + gy, yes))                # slot 15
        for (pxv, pyv, _), il in zip(par, inls):                 # slots 16-24
            cands.append((pxv, pyv, il))

    # scale to level resolution (ref: hme.c:1522-1526)
    dxs = torch.stack([c[0] >> level for c in cands], dim=1)     # (L, S)
    dys = torch.stack([c[1] >> level for c in cands], dim=1)
    oks = torch.stack([c[2] for c in cands], dim=1)
    use = oks & ~invalid_block(bx[:, None] + dxs, by[:, None] + dys,
                               bw[:, None], bh[:, None], 0, fw, fh)
    rw = window(refl, bx[:, None] + dxs, by[:, None] + dys, y_h, y_w)
    args = (src_w[:, None], rw, bw[:, None], bh[:, None])
    if level > 1:
        raws = masked_sse(*args)
    else:
        raws = masked_metr(*args, ew[:, None], tw[:, None], aw[:, None])
    px_, py_ = g["pred"]
    scs = raws + mv_cost(px_[:, None], py_[:, None], y_w, y_h, cfg.vid_w,
                         cfg.vid_h, dxs * step * 4, dys * step * 4, quant,
                         1 if level > 1 else 0)
    hit = (dxs == _e(lax_, 1)) & (dys == _e(lay_, 1))
    scs = torch.where(hit, torch.clamp(scs - _e(motion_bias >> level, 1),
                                       min=0), scs)
    # value-equal duplicates of an earlier USED slot are skipped (the
    # reference dedupes, hme.c:1166-1182); the best slot is the first
    # strict minimum below I32MAX
    ns = dxs.shape[1]
    eq = (dxs[:, :, None] == dxs[:, None, :]) & (dys[:, :, None]
                                                 == dys[:, None, :])
    tri = torch.ones((ns, ns), dtype=torch.bool, device=i.device).tril(-1)
    dup = (eq & use[:, None, :] & tri).any(dim=2)
    scm = torch.where(use & ~dup, scs, I32MAX)
    kbest = scm.argmin(dim=1, keepdim=True)
    best_score = scm.gather(1, kbest)[:, 0]
    found = best_score < I32MAX
    dx = torch.where(found, dxs.gather(1, kbest)[:, 0], 0)
    dy = torch.where(found, dys.gather(1, kbest)[:, 0], 0)
    score_zero = torch.where(use[:, 0], raws[:, 0], I32MAX)

    # ---- good-enough vs source reference (ref: hme.c:1569-1584) ----
    qthresh = (quant * bw * bh) >> 11
    qthresh = torch.where((dx.abs() <= 1) & (dy.abs() <= 1), qthresh * 2,
                          qthresh)
    ogr_w = window(ogrl, bx, by, y_h, y_w)
    zoscore = masked_metr(src_w, ogr_w, bw, bh, ew, tw, aw)
    ge0 = zoscore < qthresh
    best0_ge = score_zero if level == 0 else zero
    best0 = torch.where(ge0, best0_ge, best_score)
    dx = torch.where(ge0, 0, dx)
    dy = torch.where(ge0, 0, dy)

    # ---- greedy refine (skipped entirely on good-enough-zero) ----
    rdx, rdy, rbest, rgood = _refine_loop(
        cfg, level, src_w, refl, bx, by, bw, bh, (ew, tw, aw), dx, dy,
        best0, qthresh, px_, py_, quant, fw, fh, valid & ~ge0)
    return dict(valid=valid, i=i, j=j, bx=bx, by=by, bw=bw, bh=bh,
                dx=torch.where(ge0, 0, rdx), dy=torch.where(ge0, 0, rdy),
                best=torch.where(ge0, best0_ge, rbest),
                good=ge0 | (rgood & ~ge0), lax=lax_, lay=lay_,
                motion_bias=motion_bias, var_src=var_src, avg_src=avg_src,
                psy=(ew, tw, aw), src_w=src_w, score_zero=score_zero)


def lane_grid(cfg, level):
    """(step, ca, cb, nd): block step, the level's block grid (ca x cb
    positions) and its number of anti-diagonals."""
    step = 1 << level
    ca = (cfg.nbh + step - 1) // step
    cb = (cfg.nbv + step - 1) // step
    return step, ca, cb, ca + cb - 1


@functools.lru_cache(maxsize=None)
def _diagonals(cfg, level):
    """Per anti-diagonal d: the (i, j) block coordinates of its lanes,
    int32 numpy (lanes a = max(0, d - cb + 1) .. min(d, ca - 1))."""
    step, ca, cb, nd = lane_grid(cfg, level)
    out = []
    for d in range(nd):
        a = np.arange(max(0, d - (cb - 1)), min(d, ca - 1) + 1)
        out.append(((a * step).astype(np.int32),
                    ((d - a) * step).astype(np.int32)))
    return tuple(out)


def _diag_arrays(cfg, level, d):
    return _diagonals(cfg, level)[d]


def _diag_ij(cfg, level, d, dev):
    """The lanes of diagonal d as int32 (i, j) tensors on dev (cached)."""
    return on_device(dev, _diag_arrays, cfg, level, d)


def refine_level_graph(cfg, level, srcl, refl, ogrl, parent_x, parent_y,
                       tmv_x, tmv_y, gx, gy, quant):
    """Upper pyramid levels (no mode decisions): returns (fx, fy) int32
    fields in full-resolution full-pel units (ref: hme.c:1594-1596)."""
    step, _, _, nd = lane_grid(cfg, level)
    dev = srcl.device
    fx = torch.zeros((cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
    fy = torch.zeros_like(fx)
    carry = dict(fx=fx, fy=fy, fskip=torch.zeros_like(fx))
    for d in range(nd):
        i, j = _diag_ij(cfg, level, d, dev)
        g = gather_ctx(cfg, level, carry, parent_x, parent_y, tmv_x, tmv_y,
                       i, j)
        r = _block_search(cfg, level, g, srcl, refl, ogrl, gx, gy, quant,
                          i, j, torch.ones_like(i, dtype=torch.bool))
        v = r["valid"]
        fx[j.long(), i.long()] = torch.where(v, r["dx"] * step, 0)
        fy[j.long(), i.long()] = torch.where(v, r["dy"] * step, 0)
    return fx, fy


def global_motion_graph(cfg, level, fx, fy):
    """(ref: hme.c:1973-1999). Returns 0-d int32 tensors."""
    step, ca, cb, _ = lane_grid(cfg, level)
    sx = fx[0::step, 0::step].sum(dtype=_I32)
    sy = fy[0::step, 0::step].sum(dtype=_I32)
    n = ca * cb
    return tint.divt(sx * 2, n), tint.divt(sy * 2, n)


# ---------------------------------------------------------------------------
# level 0: subpel + mode decisions (ref: hme.c:1051-1164, 1598-1821)
# ---------------------------------------------------------------------------

_DX4 = (1, -1, 0, 0)
_DY4 = (0, 0, 1, -1)


def _subpel(cfg, srcl, refl, bx, by, bw, bh, fpx, fpy, best_fp, psy,
            px_, py_, quant):
    """(ref: hme.c:1051-1164). Returns (best, sub_x, sub_y)."""
    ew, tw, aw = psy
    y_w, y_h = cfg.blk_w, cfg.blk_h
    dev = bx.device
    src_w = window(srcl, bx, by, y_h, y_w)
    yarea = bw * bh
    d4x = torch.tensor(_DX4, dtype=_I32, device=dev)
    d4y = torch.tensor(_DY4, dtype=_I32, device=dev)
    rw = window(refl, (bx + fpx)[:, None] + d4x, (by + fpy)[:, None] + d4y,
                y_h, y_w)
    quad = masked_sse(src_w[:, None], rw, bw[:, None], bh[:, None])
    quad = [quad[:, n] for n in range(4)]
    area_ratio = _fdiv(torch.full_like(yarea, 8 * 16 * 16),
                       torch.clamp(yarea, min=1))
    iarea_ratio = _fdiv(8 * yarea, 16 * 16)
    best = s32(((u32(best_fp) * u32(area_ratio)) & U32) >> 3)
    xx = bx + ((bw >> 1) - 8)
    yy = by + ((bh >> 1) - 8)
    q = qpel_grid(window(refl, xx + fpx - 2, yy + fpy - 2, 21, 21))
    srcsp = window(srcl, xx, yy, 16, 16)
    # primary/secondary direction pick (ref: hme.c:1108-1133)
    zero = torch.zeros_like(bx)
    prix = zero
    priy = torch.where(quad[3] >= quad[2], 1, -1).to(_I32)
    secx = torch.where(quad[1] >= quad[0], 1, -1).to(_I32)
    secy = zero
    ms1 = torch.where(quad[1] >= quad[0], quad[0], quad[1])
    ms2 = torch.where(quad[3] >= quad[2], quad[2], quad[3])
    swap = ms2 > ms1
    prix, secx = torch.where(swap, secx, prix), torch.where(swap, prix, secx)
    priy, secy = torch.where(swap, secy, priy), torch.where(swap, priy, secy)
    diagx = prix + secx
    diagy = priy + secy
    probes = [(prix << 1, priy << 1), (prix, priy),
              (secx << 1, secy << 1), (secx, secy),
              (diagx << 1, diagy << 1), (diagx, diagy),
              (prix + diagx, priy + diagy)]
    t0s = torch.stack([p[0] for p in probes], dim=1)
    t1s = torch.stack([p[1] for p in probes], dim=1)
    scs = qpsad(srcsp, q, t0s, t1s, ew, tw, aw) + mv_cost(
        px_[:, None], py_[:, None], y_w, y_h, cfg.vid_w, cfg.vid_h,
        fpx[:, None] * 4 + t0s, fpy[:, None] * 4 + t1s, quant, 0)
    msc = torch.full_like(bx, I32MAX)
    mt0, mt1 = zero, zero
    for k in range(7):
        t0, t1 = t0s[:, k], t1s[:, k]
        sc = scs[:, k]
        if cfg.effort < 8:      # half-pel only at low effort
            sc = torch.where(((t0 | t1) & 1) == 0, sc, I32MAX)
        take = sc < msc
        msc = torch.where(take, sc, msc)
        mt0 = torch.where(take, t0, mt0)
        mt1 = torch.where(take, t1, mt1)
    better = msc < best
    best = torch.minimum(best, msc)
    ret = s32(((u32(best) * u32(iarea_ratio)) & U32) >> 3)
    zerofp = best_fp == 0
    return (torch.where(zerofp, best_fp, ret),
            torch.where(zerofp | ~better, 0, mt0),
            torch.where(zerofp | ~better, 0, mt1))


def _max_subblock_err(pl_a, pl_b, x0, y0, rx, ry, qw, qh, bw2, bh2, psy):
    """One plane of yuv_max_subblock_err (ref: hme.c:369-409): the max
    quadrant umetr; qw/qh static quadrant window dims, bw2/bh2 per block.
    uint32 (int64)."""
    ew, tw, aw = psy
    dev = x0.device
    f = torch.tensor([0, 1, 0, 1], dtype=_I32, device=dev)
    g_ = torch.tensor([0, 0, 1, 1], dtype=_I32, device=dev)
    ox, oy = f * bw2[:, None], g_ * bh2[:, None]
    a = window(pl_a, x0[:, None] + ox, y0[:, None] + oy, qh, qw)
    b = window(pl_b, rx[:, None] + ox, ry[:, None] + oy, qh, qw)
    acc = masked_metr_acc(a, b, bw2[:, None], bh2[:, None], ew[:, None],
                          tw[:, None], aw[:, None])
    return acc.max(dim=1).values


def _calc_eprm(src_w, ref_w, bw, bh, avg_src, avg_ref):
    """(ref: hme.c:451-490)."""
    m = _mask(src_w.shape[-2], src_w.shape[-1], bw, bh, src_w.device)
    s = src_w

    def clip_any(v):
        return (m & ((v & ~0xFF) != 0)).any(dim=-1).any(dim=-1)

    return (clip_any(s - _e(avg_ref - 128)), clip_any(s - _e(avg_src - 128)),
            clip_any((s - ref_w) + 128))


def _neighbordif_self(g, cmx, cmy):
    """neighbordif2 with the current block's (not yet written) vector;
    left/top neighbour (vx, vy, skip, ok) come gathered in g["nbr"]
    (ref: dsv.c:402-438)."""
    ds = []
    for vx, vy, sk, ok in g["nbr"]:
        use = ok & ((vx != 0) | (vy != 0)) & (sk == 0)
        ds.append((torch.where(use, vx, cmx) - cmx).abs()
                  + (torch.where(use, vy, cmy) - cmy).abs())
    small = (cmx.abs() < 2) & (cmy.abs() < 2)
    return torch.where(small, 0, ds[0]), torch.where(small, 0, ds[1])


def _level0_decide(cfg, r, g, srcl, refl, ogrl, src_u, src_v, ref_u, ref_v,
                   quant, skip_thresh):
    """Mode decisions at the base level (ref: hme.c:1598-1821). r = result
    dict from _block_search, g = gather_ctx."""
    i, j = r["i"], r["j"]
    bx, by, bw, bh = r["bx"], r["by"], r["bw"], r["bh"]
    fw, fh = cfg.dims[0]
    y_w, y_h = cfg.blk_w, cfg.blk_h
    yarea = bw * bh
    area1 = torch.clamp(yarea, min=1)
    psy = r["psy"]
    ew, tw, aw = psy
    src_w = r["src_w"]
    skipt = (quant * quant) >> 19
    good = r["good"]
    fpelx0, fpely0 = r["dx"], r["dy"]
    best = torch.where((fpelx0 == r["lax"]) & (fpely0 == r["lay"]),
                       r["best"] + r["motion_bias"], r["best"])
    best_fp = best
    px_, py_ = g["pred"]
    zero = torch.zeros_like(i)

    sub_x, sub_y = zero, zero
    fpelx, fpely = fpelx0, fpely0
    if cfg.effort >= 4:
        cond1 = ~invalid_block(bx + r["lax"], by + r["lay"], bw, bh, 4,
                               fw, fh)
        ret1, sx1, sy1 = _subpel(cfg, srcl, refl, bx, by, bw, bh, r["lax"],
                                 r["lay"], best_fp, psy, px_, py_, quant)
        found1 = cond1 & ((sx1 != 0) | (sy1 != 0))
        best = torch.where(cond1, ret1, best)
        cond2 = (~found1 & ~good
                 & ~invalid_block(bx + fpelx0, by + fpely0, bw, bh, 4,
                                  fw, fh))
        ret2, sx2, sy2 = _subpel(cfg, srcl, refl, bx, by, bw, bh, fpelx0,
                                 fpely0, best_fp, psy, px_, py_, quant)
        best = torch.where(cond2, ret2, best)
        sub_x = torch.where(cond2, sx2, torch.where(found1, sx1, 0))
        sub_y = torch.where(cond2, sy2, torch.where(found1, sy1, 0))
        fpelx = torch.where(found1, r["lax"], fpelx0)
        fpely = torch.where(found1, r["lay"], fpely0)
    mvx = fpelx * 4 + sub_x
    mvy = fpely * 4 + sub_y

    # block metrics vs refs (ref: hme.c:1636-1692)
    is_subpel = ((mvx | mvy) & 3) != 0
    ratio = torch.where(
        is_subpel, s32(udiv((u32(best) << 5) & U32,
                            u32(torch.clamp(best_fp, min=1)))), 32)
    ogr_w = window(ogrl, bx + fpelx, by + fpely, y_h, y_w)
    ref_w = window(refl, bx + fpelx, by + fpely, y_h, y_w)
    ogrerr = masked_metr(src_w, ogr_w, bw, bh, ew, tw, aw)
    ogrmad = _fdiv(ogrerr + _fdiv(area1, 2), area1)
    ogrmad = s32(((u32(ogrmad) * u32(ratio)) & U32) >> 5)
    mad = _fdiv(best + _fdiv(area1, 2), area1)
    var_ref, avg_ref, _, _ = block_feat_detail(ref_w, bw, bh)
    var_src, avg_src = r["var_src"], r["avg_src"]
    dv = torch.clamp(ratio, max=32)
    ipolvar = (var_src * dv + var_ref * (32 - dv)) >> 5
    dv = (var_src - ipolvar).abs()
    maintain = (var_src > 16 * yarea) & (var_src < 32 * yarea)

    hs_ = K.fmt_h_shift(cfg.subsamp)
    vs_ = K.fmt_v_shift(cfg.subsamp)
    cbx = i * (y_w >> hs_)
    cby = j * (y_h >> vs_)
    cbmx = cbx + (fpelx >> hs_)
    cbmy = cby + (fpely >> vs_)
    cbw = bw >> hs_
    cbh = bh >> vs_
    cw_max, ch_max = y_w >> hs_, y_h >> vs_
    chroma_ratio = _fdiv((cbw * cbh) << 4, area1)

    def cavg(pl, x, y):
        return masked_avg(window(pl, x, y, ch_max, cw_max), cbw, cbh)

    uavg_src, vavg_src = cavg(src_u, cbx, cby), cavg(src_v, cbx, cby)
    uavg_ref, vavg_ref = cavg(ref_u, cbmx, cbmy), cavg(ref_v, cbmx, cbmy)
    greyish = ((uavg_src - 128).abs() < 8) & ((vavg_src - 128).abs() < 8)
    avg_y_dif = (avg_src - avg_ref).abs()
    avg_c_dif = ((uavg_src - uavg_ref).abs() + (vavg_src - vavg_ref).abs()
                 + 1) >> 1
    eprmi, eprmd, eprmr = _calc_eprm(src_w, ref_w, bw, bh, avg_src, avg_ref)
    limx = ((cfg.nbh - 1) * y_w) - 1
    limy = ((cfg.nbv - 1) * y_h) - 1
    oobx = i * y_w + (mvx >> 2)
    ooby = j * y_h + (mvy >> 2)
    oob = (oobx < 0) | (ooby < 0) | (oobx >= limx) | (ooby >= limy)
    nd0, nd1 = _neighbordif_self(g, mvx, mvy)
    neidif = _fdiv(nd0 + nd1, 3)
    ratio_u = u32(ratio)

    def subblock_errs(lx, ly, cx, cy):
        return (_max_subblock_err(srcl, refl, bx, by, lx, ly, y_w // 2,
                                  y_h // 2, bw // 2, bh // 2, psy),
                _max_subblock_err(src_u, ref_u, cbx, cby, cx, cy,
                                  cw_max // 2, ch_max // 2, cbw // 2,
                                  cbh // 2, psy),
                _max_subblock_err(src_v, ref_v, cbx, cby, cx, cy,
                                  cw_max // 2, ch_max // 2, cbw // 2,
                                  cbh // 2, psy))

    # ---- skip test (ref: hme.c:1694-1729) ----
    skip = torch.zeros_like(good)
    if not (cfg.skip_thresh_neg or cfg.lossless):
        sth = u32(skipt * yarea + 4 * var_src + yarea * skip_thresh)
        if quant < (1 << (K.MAX_QP_BITS - 2)):
            sth = ((sth * quant) & U32) >> (K.MAX_QP_BITS - 2)
        sth = torch.where(avg_y_dif <= 2,
                          torch.maximum(sth, u32(3 * (yarea + var_src))), sth)
        sth = torch.maximum(sth, u32(yarea))
        sth = torch.where(good, (sth * 2) & U32, sth)
        z0, z1, z2 = subblock_errs(bx, by, cbx, cby)
        cth = (((u32(chroma_ratio) * sth) & U32) * max(skipt, 1)) & U32
        cth = cth >> 5
        z0s = ((((z0 * ratio_u) & U32) >> 5)
               + u32(((avg_src - avg_ref) ** 2) * yarea)) & U32
        z1s = ((z1 * ratio_u) & U32) >> 5
        z2s = ((z2 * ratio_u) & U32) >> 5
        cond_try = good | ((mvx == 0) & (mvy == 0))
        skip = cond_try & (z0s <= sth) & (z1s <= cth) & (z2s <= cth)

    # ---- no-residual decisions (ref: hme.c:1731-1777) ----
    noxmity = torch.zeros_like(good)
    noxmitc = noxmity
    simcmplx = noxmity
    if not cfg.lossless:
        y_prereq = avg_y_dif <= 2
        c_prereq = ~greyish & (avg_c_dif <= 2)
        carea = 4 * cbw * cbh
        b0, b1, b2 = subblock_errs(bx + fpelx, by + fpely, cbmx, cbmy)
        xth = s32(u32(skipt * yarea) + u32(ipolvar))
        xth = torch.clamp(xth - yarea * neidif * 2, min=0)
        xth = s32(((u32(xth) * quant) & U32) >> K.MAX_QP_BITS)
        xth = torch.minimum(torch.clamp(xth, min=32), yarea * 4)
        b0s = ((b0 * ratio_u) & U32) >> 5
        b1s = ((b1 * ratio_u) & U32) >> 5
        b2s = ((b2 * ratio_u) & U32) >> 5
        utex = block_feat_detail(window(src_u, cbx, cby, ch_max, cw_max),
                                 cbw, cbh)[3]
        vtex = block_feat_detail(window(src_v, cbx, cby, ch_max, cw_max),
                                 cbw, cbh)[3]
        c_prereq = c_prereq & ((utex > carea) | (vtex > carea))
        xthc = (chroma_ratio * xth) >> 4
        pre = ~oob & (y_prereq | c_prereq)
        noxmity = pre & y_prereq & (b0s < u32(4 * xth))
        noxmitc = (pre & c_prereq & (b1s < u32(xthc)) & (b2s < u32(xthc)))
        simcmplx = ~oob & (dv < _fdiv(var_src, 4))
    return dict(mvx=mvx, mvy=mvy, fpelx=fpelx, fpely=fpely, best=best,
                best_fp=best_fp, ratio=ratio, skip=skip, noxmity=noxmity,
                noxmitc=noxmitc, simcmplx=simcmplx, maintain=maintain,
                mad=mad, ogrmad=ogrmad, ipolvar=ipolvar, avg_src=avg_src,
                avg_ref=avg_ref, avg_c_dif=avg_c_dif, eprmi=eprmi,
                eprmd=eprmd, eprmr=eprmr, neidif=neidif,
                cb=(cbx, cby, cbmx, cbmy, cbw, cbh))


def _quad_offsets(dev, sbw, sbh):
    f = torch.tensor([q[0] for q in _QUADS], dtype=_I32, device=dev)
    g_ = torch.tensor([q[1] for q in _QUADS], dtype=_I32, device=dev)
    return f * sbw[:, None], g_ * sbh[:, None]


def _test_intra_y(cfg, d0, srcl, refl, bx, by, fpelx, fpely, bw, bh,
                  refmv_x, refmv_y, psyscale):
    """(ref: hme.c:891-985). Returns (submask, dc, intra)."""
    mvx, mvy = d0["mvx"], d0["mvy"]
    neidif = d0["neidif"]
    ratio = d0["ratio"]
    detail0 = d0["ipolvar"]
    avg_src = d0["avg_src"]
    sbw, sbh = _fdiv(bw, 2), _fdiv(bh, 2)
    skip_all = (((mvx != 0) | (mvy != 0)) & (neidif < 3)
                & ((refmv_x - mvx).abs() < 3) & ((refmv_y - mvy).abs() < 3))
    skip_all = skip_all | (sbw == 0) | (sbh == 0)
    detail_src = detail0 + _fdiv(detail0, torch.clamp(neidif, min=1))
    qw, qh = cfg.blk_w // 2, cfg.blk_h // 2
    ox, oy = _quad_offsets(bx.device, sbw, sbh)
    # the per-quad window metrics do not depend on the sequential state;
    # only the decay/take decisions below do
    src_d = window(srcl, bx[:, None] + ox, by[:, None] + oy, qh, qw)
    mvr_d = window(refl, (bx + fpelx)[:, None] + ox,
                   (by + fpely)[:, None] + oy, qh, qw)
    sbw4, sbh4 = sbw[:, None].expand(-1, 4), sbh[:, None].expand(-1, 4)
    _, avg_sub, _, _ = block_feat_detail(mvr_d, sbw4, sbh4)
    local_detail, avg_local, _, _ = block_feat_detail(src_d, sbw4, sbh4)
    dcd = (avg_local - avg_sub).abs() + 2
    too_detailed = u32(local_detail) > (
        ((u32(dcd * dcd * (bw * bh)[:, None]) * u32(ratio)[:, None]) & U32)
        >> 5)
    dc = (avg_local + avg_src[:, None] * 3 + 2) >> 2
    sub_err, src_err, inter_err = err_intra(
        src_d, mvr_d, sbw4, sbh4, avg_sub, dc, ratio[:, None].expand(-1, 4))
    zero = torch.zeros_like(bx)
    submask, avg_tot, nsub = zero, zero, zero
    err_sub = zero.to(_I64)
    err_src = err_sub
    # detail_src decays when a sub-block is taken: sequential over the 4
    for k, (_, _, bit) in enumerate(_QUADS):
        lo = (detail_src + local_detail[:, k] + 1) >> 1
        lerp = (lo * (32 - psyscale) + detail_src * psyscale) >> 5
        ld2 = u32(torch.maximum(lerp, lo))
        sub_better = ((sub_err[:, k] + ld2) & U32) < inter_err[:, k]
        src_better = ((src_err[:, k] + ld2) & U32) < inter_err[:, k]
        take = ~skip_all & ~too_detailed[:, k] & (sub_better | src_better)
        submask = submask | torch.where(take, bit, 0)
        err_src = (err_src + torch.where(take, src_err[:, k], 0)) & U32
        err_sub = (err_sub + torch.where(take, sub_err[:, k], 0)) & U32
        avg_tot = avg_tot + torch.where(
            take, torch.where(sub_err[:, k] < src_err[:, k], avg_sub[:, k],
                              dc[:, k]), 0)
        nsub = nsub + take.to(_I32)
        detail_src = torch.where(take, _fdiv(detail_src * 4, 5), detail_src)
    intra = submask != 0
    dc_out = torch.where(intra & (err_src < err_sub),
                         _fdiv(avg_tot, torch.clamp(nsub, min=1))
                         | K.SRC_DC_PRED, 0)
    return submask, dc_out, intra


def _test_intra_c(cfg, d0, src_u, src_v, ref_u, ref_v, submask, intra):
    """(ref: hme.c:987-1048)."""
    if cfg.effort < 6:
        return submask, intra
    mvx, mvy = d0["mvx"], d0["mvy"]
    cbx, cby, cbmx, cbmy, cbw, cbh = d0["cb"]
    detail_src = _fdiv(d0["ipolvar"], torch.clamp(d0["bwbh"], min=1))
    avg_src = d0["avg_src"]
    sbw, sbh = _fdiv(cbw, 2), _fdiv(cbh, 2)
    qw = (cfg.blk_w >> K.fmt_h_shift(cfg.subsamp)) // 2
    qh = (cfg.blk_h >> K.fmt_v_shift(cfg.subsamp)) // 2
    thr = torch.where(intra, detail_src, detail_src * detail_src)
    small_mv = (mvx.abs() < 4) & (mvy.abs() < 4)
    blocked = ((sbw == 0) | (sbh == 0) | (u32(d0["mad"]) <= u32(thr))
               | (u32(thr) > 64) | small_mv)
    avg_ramp = (avg_src * avg_src) >> 8
    ox, oy = _quad_offsets(cbx.device, sbw, sbh)
    sbw4, sbh4 = sbw[:, None].expand(-1, 4), sbh[:, None].expand(-1, 4)

    def avg(pl, x, y):
        return masked_avg(window(pl, x[:, None] + ox, y[:, None] + oy, qh,
                                 qw), sbw4, sbh4)

    us, vs_a = avg(src_u, cbx, cby), avg(src_v, cbx, cby)
    ur, vr = avg(ref_u, cbmx, cbmy), avg(ref_v, cbmx, cbmy)
    difs = ((((us - ur) ** 2) + ((vs_a - vr) ** 2)) * avg_ramp[:, None]) >> 8
    add = torch.zeros_like(submask)
    for k, (_, _, bit) in enumerate(_QUADS):
        already = (submask & bit) != 0
        take = ~blocked & ~already & (u32(difs[:, k]) > u32(thr))
        add = add + torch.where(take, bit, 0)
    submask = submask | add
    return submask, submask != 0


def level0_block(cfg, g, srcl, refl, ogrl, src_u, src_v, ref_u, ref_v,
                 gx, gy, quant, skip_thresh, i_, j_, ok_):
    """Complete base-level pipeline for the blocks (i_, j_): search +
    subpel + mode decisions + intra tests + flag assembly (ref:
    hme.c:1598-1833). Returns the per-block outputs and stat deltas."""
    r = _block_search(cfg, 0, g, srcl, refl, ogrl, gx, gy, quant, i_, j_,
                      ok_)
    d0 = _level0_decide(cfg, r, g, srcl, refl, ogrl, src_u, src_v, ref_u,
                        ref_v, quant, skip_thresh)
    d0["bwbh"] = r["bw"] * r["bh"]
    # intra tests (ref: hme.c:1779-1788)
    if cfg.has_tmv:
        rmx, rmy = g["tmv_c"]
    else:
        rmx, rmy = d0["mvx"], d0["mvy"]
    fpelx, fpely = d0["fpelx"], d0["fpely"]
    submask, dc, intra = _test_intra_y(
        cfg, d0, srcl, refl, r["bx"], r["by"], fpelx, fpely, r["bw"],
        r["bh"], rmx, rmy, cfg.psyf_all)
    submask, intra = _test_intra_c(cfg, d0, src_u, src_v, ref_u, ref_v,
                                   submask, intra)
    # EPRM merge (ref: hme.c:1801-1820)
    eprmi, eprmd, eprmr = d0["eprmi"], d0["eprmd"], d0["eprmr"]
    m_intra = torch.where((dc & K.SRC_DC_PRED) != 0, eprmd, eprmi)
    m_intra = m_intra | ((submask != K.MASK_ALL_INTRA) & eprmr)
    m_inter = eprmr | ((submask != 0) & eprmi)
    eprm = torch.where(intra, m_intra, m_inter)
    mvx = torch.where(intra, fpelx * 4, d0["mvx"])
    mvy = torch.where(intra, fpely * 4, d0["mvy"])
    simc = d0["simcmplx"] & ~(intra | eprm)
    skip = d0["skip"]
    # skip overrides everything (ref: hme.c:1722-1728)
    mvx = torch.where(skip, 0, mvx)
    mvy = torch.where(skip, 0, mvy)
    intra = intra & ~skip
    eprm = eprm & ~skip
    simc = simc & ~skip
    noxy = d0["noxmity"] & ~skip
    noxc = d0["noxmitc"] & ~skip
    maint = d0["maintain"]  # set before the skip test, kept
    err = torch.where(skip | noxy, 0, d0["mad"]) & 0xFFFF
    flags = sum(b.to(_I32) << bit for b, bit in (
        (intra, K.MV_BIT_INTRA), (eprm, K.MV_BIT_EPRM),
        (maint, K.MV_BIT_MAINTAIN), (skip, K.MV_BIT_SKIP),
        (noxy, K.MV_BIT_NOXMITY), (noxc, K.MV_BIT_NOXMITC),
        (simc, K.MV_BIT_SIMCMPLX)))
    # stats (ref: hme.c:1789-1799, 1825-1831)
    v = r["valid"]
    terr = torch.where(v & ~skip & ~noxy, d0["mad"], 0)
    ndiff = torch.where(v & ~skip, (d0["ogrmad"] > 11).to(_I32)
                        + (d0["avg_c_dif"] >= 32).to(_I32), 0)
    nelig = (v & (d0["best"] > 0)).to(_I32)
    nintra = (v & intra).to(_I32)
    return (mvx, mvy, flags, err, dc, submask, skip.to(torch.uint8), v,
            terr, ndiff, nelig, nintra)


FIELDS0 = ("fx", "fy", "flags", "err", "dc", "submask")
SUMS0 = ("terr", "ndiff", "nelig", "nintra")


def refine_level0_graph(cfg, srcs, refs, ogrl, parent_x, parent_y,
                        tmv_x, tmv_y, gx, gy, quant, skip_thresh):
    """Base level: search + subpel + mode decisions (ref: hme.c:1372-1833).
    srcs/refs = (luma, u, v) bordered planes. Returns the field grids
    (int32; fskip uint8) and the frame statistics (0-d int32)."""
    srcl, src_u, src_v = srcs
    refl, ref_u, ref_v = refs
    dev = srcl.device
    _, _, _, nd = lane_grid(cfg, 0)
    st = {k: torch.zeros((cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
          for k in FIELDS0}
    st["fskip"] = torch.zeros((cfg.nbv, cfg.nbh), dtype=torch.uint8,
                              device=dev)
    sums = torch.zeros(len(SUMS0), dtype=_I32, device=dev)
    carry = dict(fx=st["fx"], fy=st["fy"], fskip=st["fskip"])
    for d in range(nd):
        i, j = _diag_ij(cfg, 0, d, dev)
        g = gather_ctx(cfg, 0, carry, parent_x, parent_y, tmv_x, tmv_y, i, j)
        out = level0_block(cfg, g, srcl, refl, ogrl, src_u, src_v, ref_u,
                           ref_v, gx, gy, quant, skip_thresh, i, j,
                           torch.ones_like(i, dtype=torch.bool))
        v = out[7]
        jl, il = j.long(), i.long()
        for k, val in zip(FIELDS0 + ("fskip",), out[:7]):
            st[k][jl, il] = torch.where(v, val, 0).to(st[k].dtype)
        sums += torch.stack(out[8:]).sum(dim=1, dtype=_I32)
    for k, s in zip(SUMS0, sums):
        st[k] = s
    return st


def make_motion_est(cfg):
    """The full pyramid search (ref: hme.c:2001-2016): fn(src_planes,
    ref_planes, ogr_planes, src_u, src_v, ref_u, ref_v, tmv_x, tmv_y,
    quant, skip_thresh) -> dict of the level-0 fields and frame sums.
    Planes are bordered uint8 tensors (per pyramid level for the luma
    lists), tmv_x/tmv_y (nbv, nbh) int32, quant and skip_thresh ints."""

    def f(src_planes, ref_planes, ogr_planes, src_u, src_v, ref_u, ref_v,
          tmv_x, tmv_y, quant, skip_thresh):
        quant, skip_thresh = int(quant), int(skip_thresh)
        dev = src_planes[0].device
        gx = torch.zeros((), dtype=_I32, device=dev)
        gy = gx
        parent_x = torch.zeros((cfg.nbv, cfg.nbh), dtype=_I32, device=dev)
        parent_y = parent_x
        for level in range(cfg.pyramid_levels, 0, -1):
            fx, fy = refine_level_graph(
                cfg, level, src_planes[level], ref_planes[level],
                ogr_planes[level], parent_x, parent_y, tmv_x, tmv_y, gx, gy,
                quant)
            gx, gy = global_motion_graph(cfg, level, fx, fy)
            parent_x, parent_y = fx, fy
        return refine_level0_graph(
            cfg, (src_planes[0], src_u, src_v), (ref_planes[0], ref_u, ref_v),
            ogr_planes[0], parent_x, parent_y, tmv_x, tmv_y, gx, gy, quant,
            skip_thresh)

    return f


def prepare_motion_est(enc, d):
    """(cfg, inputs) of the whole-pyramid search for frame d against its
    reference, from the device reference chain: every plane input is a
    device tensor (d.dev: input prep; d.refdata.dev: the reference's
    chain), the only upload is the reference's final MV field."""
    ref = d.refdata
    p = d.params
    has_tmv = ref.final_mvs is not None
    w0, h0 = p.meta.width, p.meta.height
    dims = [(w0, h0)] + [(im.round_shift(w0, i + 1), im.round_shift(h0, i + 1))
                         for i in range(enc.pyramid_levels)]
    srcp = [d.dev["padded"][0]] + list(d.dev["pyr"])
    refp = [ref.dev["recon"][0]] + list(ref.dev["rpyr"])
    ogrp = [ref.dev["padded"][0]] + list(ref.dev["pyr"])
    cfg = WaveCfg(p.nbh, p.nbv, p.blk_w, p.blk_h, w0, h0, p.meta.subsamp,
                  p.effort, p.lossless, enc.pyramid_levels, has_tmv,
                  enc.skip_block_thresh < 0, tuple(dims))
    dev = srcp[0].device
    if has_tmv:
        mf = ref.final_mvs
        tmv = torch.as_tensor(np.stack([mf.grid(mf.x), mf.grid(mf.y)])
                              .astype(np.int32)).to(dev)
        tmvx, tmvy = tmv[0], tmv[1]
    else:
        tmvx = torch.zeros((p.nbv, p.nbh), dtype=_I32, device=dev)
        tmvy = tmvx
    inputs = (tuple(srcp), tuple(refp), tuple(ogrp),
              d.dev["padded"][1], d.dev["padded"][2],
              ref.dev["recon"][1], ref.dev["recon"][2],
              tmvx, tmvy, int(enc.prev_quant), int(enc.skip_block_thresh))
    return cfg, inputs


def apply_motion_est(enc, d, st):
    """Unpack the search's output dict into the encoder state: one fetch
    of the stacked fields, one of the sums."""
    from ..codec.motion import MotionField

    p = d.params
    grids = torch.stack([st[k] for k in FIELDS0]
                        + [st["fskip"].to(_I32)]).cpu().numpy()
    sums = torch.stack([st[k] for k in SUMS0]).cpu().numpy()
    fl = dict(zip(FIELDS0, grids))
    mf = MotionField(p.nbh, p.nbv)
    mf.x = fl["fx"].reshape(-1).astype(np.int16)
    mf.y = fl["fy"].reshape(-1).astype(np.int16)
    mf.flags = fl["flags"].reshape(-1).astype(np.uint32)
    mf.err = fl["err"].reshape(-1).astype(np.uint16)
    mf.dc = fl["dc"].reshape(-1).astype(np.uint16)
    mf.submask = fl["submask"].reshape(-1).astype(np.uint8)
    d.final_mvs = mf
    terr, ndiff, nelig, nintra = (int(x) for x in sums)
    nblk = p.nbh * p.nbv
    enc.curr_scblocks = ndiff * 100 // max(nelig, 1)
    enc.avg_err = terr // nblk
    enc.curr_intra_pct = nintra * 100 // nblk
