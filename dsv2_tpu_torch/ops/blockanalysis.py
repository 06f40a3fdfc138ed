"""Per-block HVS intra analysis (encoder), on the host and on the device.

Port of `dsv2_tpu/ops/blockanalysis.py` (ref: src/hme.c:492-749,
1835-1971). The host half — the numpy block features, `intra_analysis`
(grouped fast path and per-block scalar path), the grid grouping and the
preconditions — is copied as it is. The device half,
`device_intra_flags` with its torch `_group_flags`, runs the grouped
fast path as torch ops. Every device reduction stays in int32 like the
JAX twin (torch would promote to int64), and the two 16-bin histograms
are a scatter-add into (nblocks, 16) rather than the twin's one-hot
compare.
"""
import numpy as np
import torch

from ..codec.motion import MotionField
from ..core import constants as K
from ..core import intmath as im
from .tint import isqrt_u32

NHIST = 16
HISTBITS = 4


def avg2(a, b):
    return (a + b + 1) >> 1


def block_detail(a):
    """(detail, avg) (ref: hme.c:546-584)."""
    p = a.astype(np.int64)
    s = int(p.sum())
    h, w = p.shape
    sh = int(np.abs(p[:, 1:] - p[:, :-1]).sum())
    sv = int(np.abs(p[1:, :] - p[:-1, :]).sum())
    avg = s // (w * h)
    var = int(np.abs(p - avg).sum())
    var >>= 1
    tex = max(sh, sv) - var
    return var + max(tex, 0), avg


def block_var(a):
    """(var, avg) (ref: hme.c:518-543)."""
    p = a.astype(np.int64)
    h, w = p.shape
    avg = int(p.sum()) // (w * h)
    return int(np.abs(p - avg).sum()), avg


def block_tex(a):
    """max(sum|dx|, sum|dy|) (ref: hme.c:492-516)."""
    p = a.astype(np.int64)
    sh = int(np.abs(p[:, 1:] - p[:, :-1]).sum())
    sv = int(np.abs(p[1:, :] - p[:-1, :]).sum())
    return max(sh, sv)


def quant_tex(a):
    """Squared texture of 4-bit-quantized samples (ref: hme.c:586-617)."""
    p = (a.astype(np.int64) >> 4)
    h, w = p.shape
    dh = p[:, :-1] - p[:, 1:]
    sh = int((dh * dh).sum())
    dv = p[1:, :] - p[:-1, :]
    sv = int((dv * dv).sum())
    return im.iisqrt(max(sh, sv)) // avg2(w, h)


def block_hist_var(a):
    """Histogram variance of luma-normalized samples (ref: hme.c:711-749)."""
    p = a.astype(np.int64)
    h, w = p.shape
    avg = int(p.sum()) // (w * h)
    if avg == 0:
        avg = 1
    quant16 = ((1 << (HISTBITS - 1)) << 16) // avg
    hi = np.clip((p * quant16) >> 16, 0, NHIST - 1)
    hist = np.bincount(hi.ravel(), minlength=NHIST)[:NHIST]
    havg = int(hist.sum()) // NHIST
    var = int(((hist - havg) ** 2).sum())
    return (var * 16 * 16) // (NHIST * w * h * w * h)


def block_peaks(a, bavg):
    """Number of histogram peaks over 2x-downsampled samples
    (ref: hme.c:624-692). Returns (npeaks, hist)."""
    p = a.astype(np.int64)
    h, w = p.shape
    avg = bavg
    if bavg < 0:
        avg = int(p.sum()) // (w * h)
    if avg == 0:
        avg = 1
    quant16 = ((1 << (HISTBITS - 1)) << 16) // avg
    w2, h2 = w // 2, h // 2
    ds = (p[0:2 * h2:2, 0:2 * w2:2] + p[0:2 * h2:2, 1:2 * w2:2]
          + p[1:2 * h2:2, 0:2 * w2:2] + p[1:2 * h2:2, 1:2 * w2:2] + 2) >> 2
    hi = np.minimum((ds * quant16) >> 16, NHIST - 1)
    hist = np.bincount(hi.ravel(), minlength=NHIST)[:NHIST]
    havg = int(hist.sum()) // NHIST
    maxv = int(hist.max(initial=0)) >> 2
    npeaks = 0
    for x in range(NHIST):
        c = int(hist[x])
        is_peak = True
        if x > 0:
            is_peak &= c > hist[x - 1]
        if x < NHIST - 1:
            is_peak &= c > hist[x + 1]
        is_peak &= (c > maxv) or (c > havg)
        if is_peak:
            npeaks += 1
    return npeaks, hist


def c_average(u, v):
    """(uavg, vavg) over a chroma block (ref: hme.c:751-773)."""
    n = u.size
    return int(u.astype(np.int64).sum()) // n, int(v.astype(np.int64).sum()) // n


def chroma_analysis(y, u, v):
    """(nature, greyish, skinnish, hifreq) (ref: hme.c:69-78)."""
    nature = u < 128 and v < 160
    greyish = abs(u - 128) < 8 and abs(v - 128) < 8
    skinnish = (y > 80) and (y < 230) and abs(u - 108) < 24 and abs(v - 148) < 24
    hifreq = (u > 160) and not greyish and not skinnish
    return nature, greyish, skinnish, hifreq


def _batched_features(blocks):
    """Vectorized block features over an (N, bh, bw) uint8 stack. Returns a
    dict of (N,) int64 arrays with C-exact semantics."""
    p = blocks.astype(np.int64)
    n, bh, bw = p.shape
    area = bw * bh
    s = p.sum(axis=(1, 2))
    sh = np.abs(p[:, :, 1:] - p[:, :, :-1]).sum(axis=(1, 2))
    sv = np.abs(p[:, 1:, :] - p[:, :-1, :]).sum(axis=(1, 2))
    avg = s // area
    var = np.abs(p - avg[:, None, None]).sum(axis=(1, 2))
    dvar = var >> 1
    tex = np.maximum(sh, sv) - dvar
    detail = dvar + np.maximum(tex, 0)
    # quant_tex (ref: hme.c:586-617)
    q4 = p >> 4
    dh = q4[:, :, :-1] - q4[:, :, 1:]
    sh2 = (dh * dh).sum(axis=(1, 2))
    dv = q4[:, 1:, :] - q4[:, :-1, :]
    sv2 = (dv * dv).sum(axis=(1, 2))
    qtex = im.iisqrt(np.maximum(sh2, sv2)) // avg2(bw, bh)
    # histogram variance (ref: hme.c:711-749)
    havg = np.maximum(avg, 1)
    quant16 = ((1 << (HISTBITS - 1)) << 16) // havg
    hi = np.clip((p * quant16[:, None, None]) >> 16, 0, NHIST - 1)
    off = (np.arange(n)[:, None, None] * NHIST + hi).ravel()
    hist = np.bincount(off, minlength=n * NHIST).reshape(n, NHIST)
    hm = hist.sum(axis=1) // NHIST
    hvar_raw = ((hist - hm[:, None]) ** 2).sum(axis=1)
    hvar = (hvar_raw * 256) // (NHIST * area * area)
    # peaks over 2x downsample (ref: hme.c:624-692)
    w2, h2 = bw // 2, bh // 2
    ds = (p[:, 0:2 * h2:2, 0:2 * w2:2] + p[:, 0:2 * h2:2, 1:2 * w2:2]
          + p[:, 1:2 * h2:2, 0:2 * w2:2] + p[:, 1:2 * h2:2, 1:2 * w2:2]
          + 2) >> 2
    hi2 = np.minimum((ds * quant16[:, None, None]) >> 16, NHIST - 1)
    off2 = (np.arange(n)[:, None, None] * NHIST + hi2).ravel()
    ph = np.bincount(off2, minlength=n * NHIST).reshape(n, NHIST)
    pavg = ph.sum(axis=1) // NHIST
    maxv = (ph.max(axis=1)) >> 2
    left = np.concatenate(
        [np.full((n, 1), -1, ph.dtype), ph[:, :-1]], axis=1)
    right = np.concatenate(
        [ph[:, 1:], np.full((n, 1), -1, ph.dtype)], axis=1)
    is_peak = ((ph > left) & (ph > right)
               & ((ph > maxv[:, None]) | (ph > pavg[:, None])))
    npeaks = is_peak.sum(axis=1)
    return dict(detail=detail, avg=avg, var=var, tex=np.maximum(sh, sv),
                qtex=qtex, hvar=hvar, npeaks=npeaks)


def _grid_groups(w, h, bw, bh):
    """Static block groups tiling a (w, h) plane with a bw x bh grid:
    interior + right column + bottom row + corner, each group's blocks
    equally sized. Yields (j0, nj, i0, ni, gbw, gbh)."""
    nbh_f, nbv_f = w // bw, h // bh
    wr, hr = w - nbh_f * bw, h - nbv_f * bh
    groups = []
    if nbh_f and nbv_f:
        groups.append((0, nbv_f, 0, nbh_f, bw, bh))
    if wr and nbv_f:
        groups.append((0, nbv_f, nbh_f, 1, wr, bh))
    if hr and nbh_f:
        groups.append((nbv_f, 1, 0, nbh_f, bw, hr))
    if wr and hr:
        groups.append((nbv_f, 1, nbh_f, 1, wr, hr))
    return groups


def _vector_ok(w, h, params):
    """The vectorized/device analysis handles every group whose luma
    blocks are >= 2x2 with non-empty chroma blocks (interior chroma >= 2
    like the original fast path)."""
    p = params
    hs = K.fmt_h_shift(p.meta.subsamp)
    vs = K.fmt_v_shift(p.meta.subsamp)
    if (p.blk_w >> hs) < 2 or (p.blk_h >> vs) < 2:
        return False
    for (j0, nj, i0, ni, gbw, gbh) in _grid_groups(w, h, p.blk_w, p.blk_h):
        if gbw < 2 or gbh < 2 or (gbw >> hs) < 1 or (gbh >> vs) < 1:
            return False
    return True


def intra_analysis(frame, params):
    """I-frame psychovisual block classification (ref: hme.c:1835-1971).
    frame: core.frame.Frame (bordered, extended). Returns a MotionField
    with RINGING/MAINTAIN/SKIP(keep-HF) flags. Blocks are processed as
    batched reductions per equal-size group (interior + edges); tiny edge
    slivers fall back to the scalar path."""
    lum0 = frame.view(0)
    p = params
    if _vector_ok(lum0.shape[1], lum0.shape[0], p):
        return _intra_analysis_fast(frame, params)
    return _intra_analysis_scalar(frame, params)


def _host_group_flags(xp, f, uavg, vavg, area, scale, do_psy):
    """(ringing, maintain, keep_hf) bool arrays from a feature dict +
    per-block chroma averages; np/jnp-agnostic twin of the scalar logic."""
    detail = f["detail"]
    avg = f["avg"]
    n = detail.shape[0]
    ringing = xp.zeros(n, dtype=bool)
    foliage = xp.zeros(n, dtype=bool)
    is_text = xp.zeros(n, dtype=bool)
    var_t = xp.full(n, 16, detail.dtype)
    if do_psy & (K.PSY_ADAPTIVE_RINGING | K.PSY_CONTENT_ANALYSIS):
        hvar, qtex, npeaks = f["hvar"], f["qtex"], f["npeaks"]
        luma_var = f["var"] // area
        luma_tex = f["tex"] // area
        is_text = xp.abs(npeaks - 2) <= 1
        tf2 = (((qtex == 1) | (qtex == 2)) & (hvar <= 3)
               & (luma_tex >= 10) & (luma_var >= luma_tex))
        tf = (((qtex == 2) | (qtex == 3)) & (luma_tex >= 8)
              & (luma_var >= 2 * luma_tex) & (xp.abs(hvar - 5) <= 3))
        is_text &= (tf | tf2)
        nature = (uavg < 128) & (vavg < 160)
        greyish = (xp.abs(uavg - 128) < 8) & (xp.abs(vavg - 128) < 8)
        skinnish = ((avg > 80) & (avg < 230) & (xp.abs(uavg - 108) < 24)
                    & (xp.abs(vavg - 148) < 24))
        hifreq = (uavg > 160) & ~greyish & ~skinnish
        foliage = nature & (avg < 160) & (detail
                                          > (36 * area) // max(scale, 1))
        is_text &= ~foliage
        ring_cond = foliage | ((hvar <= xp.minimum(qtex - 3, 2) * 16)
                               & (qtex > 1))
        if do_psy & K.PSY_ADAPTIVE_RINGING:
            ringing = ~hifreq & ring_cond
        var_t = xp.where(nature | greyish | skinnish, 20,
                         xp.where(~hifreq, 16, 8))
    maintain = xp.ones(n, dtype=bool)
    keep_hf = xp.ones(n, dtype=bool)
    if do_psy & (K.PSY_CONTENT_ANALYSIS | K.PSY_ADAPTIVE_QUANT):
        d = detail // area
        keep_hf &= d < 48
        maintain = d < var_t * 4
    if do_psy & K.PSY_CONTENT_ANALYSIS:
        keep_hf = xp.where(foliage, False, xp.where(is_text, True, keep_hf))
        maintain = xp.where(foliage, True,
                            xp.where(is_text, False, maintain))
    if do_psy & K.PSY_ADAPTIVE_RINGING:
        ringing |= avg < 24
    return ringing, maintain, keep_hf


def _intra_analysis_fast(frame, params):
    p = params
    nbh, nbv = p.nbh, p.nbv
    bw, bh = p.blk_w, p.blk_h
    mf = MotionField(nbh, nbv)
    lum = frame.view(0)
    h, w = lum.shape
    subsamp = p.meta.subsamp
    hs, vs = K.fmt_h_shift(subsamp), K.fmt_v_shift(subsamp)
    scale = 2 * p.psyf_all
    do_psy = p.do_psy
    uvw = frame.view(1).astype(np.int64)
    vvw = frame.view(2).astype(np.int64)

    ring_g = np.zeros((nbv, nbh), dtype=bool)
    maint_g = np.zeros((nbv, nbh), dtype=bool)
    keep_g = np.zeros((nbv, nbh), dtype=bool)
    for (j0, nj, i0, ni, gbw, gbh) in _grid_groups(w, h, bw, bh):
        y0, x0 = j0 * bh, i0 * bw
        blocks = (lum[y0:y0 + nj * gbh, x0:x0 + ni * gbw]
                  .reshape(nj, gbh, ni, gbw).transpose(0, 2, 1, 3)
                  .reshape(nj * ni, gbh, gbw))
        f = _batched_features(blocks)
        cbw, cbh = gbw >> hs, gbh >> vs
        cy0, cx0 = (j0 * bh) >> vs, (i0 * bw) >> hs
        carea = cbw * cbh
        uavg = (uvw[cy0:cy0 + nj * cbh, cx0:cx0 + ni * cbw]
                .reshape(nj, cbh, ni, cbw).sum(axis=(1, 3))
                // carea).reshape(-1)
        vavg = (vvw[cy0:cy0 + nj * cbh, cx0:cx0 + ni * cbw]
                .reshape(nj, cbh, ni, cbw).sum(axis=(1, 3))
                // carea).reshape(-1)
        ring, maint, keep = _host_group_flags(np, f, uavg, vavg, gbw * gbh,
                                         scale, do_psy)
        ring_g[j0:j0 + nj, i0:i0 + ni] = ring.reshape(nj, ni)
        maint_g[j0:j0 + nj, i0:i0 + ni] = maint.reshape(nj, ni)
        keep_g[j0:j0 + nj, i0:i0 + ni] = keep.reshape(nj, ni)
    mf.flags = ((ring_g.reshape(-1).astype(np.uint32) << K.MV_BIT_RINGING)
                | (maint_g.reshape(-1).astype(np.uint32)
                   << K.MV_BIT_MAINTAIN)
                | (keep_g.reshape(-1).astype(np.uint32) << K.MV_BIT_SKIP))
    return mf


def _intra_analysis_scalar(frame, params):
    """Per-block reference path (handles partial edge blocks)."""
    p = params
    nbh, nbv = p.nbh, p.nbv
    y_w, y_h = p.blk_w, p.blk_h
    mf = MotionField(nbh, nbv)
    lum = frame.view(0)
    h, w = lum.shape
    subsamp = p.meta.subsamp
    hs, vs = K.fmt_h_shift(subsamp), K.fmt_v_shift(subsamp)
    uvw = frame.view(1)
    vvw = frame.view(2)
    scale = 2 * p.psyf_all
    do_psy = p.do_psy

    for j in range(nbv):
        for i in range(nbh):
            idx = i + j * nbh
            bx, by = i * y_w, j * y_h
            if bx >= w or by >= h:
                continue
            bw = min(w - bx, y_w)
            bh = min(h - by, y_h)
            blk = lum[by:by + bh, bx:bx + bw]
            cbx, cby = i * (y_w >> hs), j * (y_h >> vs)
            cbw, cbh = bw >> hs, bh >> vs
            luma_detail, luma_avg = block_detail(blk)
            maintain, keep_hf = 1, 1
            npeaks, foliage, is_text = 0, False, False
            ringing = False
            if do_psy & (K.PSY_ADAPTIVE_RINGING | K.PSY_CONTENT_ANALYSIS):
                hvar = block_hist_var(blk)
                qtex = quant_tex(blk)
                luma_var, luma_avg = block_var(blk)
                luma_var //= bw * bh
                luma_tex = block_tex(blk) // (bw * bh)
                npeaks, _ = block_peaks(blk, luma_avg)
                is_text = abs(npeaks - 2) <= 1
                tf = tf2 = False
                if qtex in (1, 2):
                    tf2 = hvar <= 3 and (luma_tex >= 10 and luma_var >= luma_tex)
                if qtex in (2, 3):
                    tf = luma_tex >= 8 and luma_var >= 2 * luma_tex
                    tf = tf and abs(hvar - 5) <= 3
                is_text = is_text and (tf or tf2)
                ub = uvw[cby:cby + cbh, cbx:cbx + cbw]
                vb = vvw[cby:cby + cbh, cbx:cbx + cbw]
                uavg, vavg = c_average(ub, vb)
                nature, greyish, skinnish, hifreq = chroma_analysis(
                    luma_avg, uavg, vavg)
                foliage = nature and luma_avg < 160
                foliage = foliage and (
                    luma_detail > (36 * bw * bh) // max(scale, 1))
                if foliage:
                    is_text = False
                skip_tones = hifreq
                if ((do_psy & K.PSY_ADAPTIVE_RINGING) and not skip_tones
                        and (foliage or (hvar <= min(qtex - 3, 2) * 16
                                         and qtex > 1))):
                    ringing = True
                var_t = 8
                if nature or greyish or skinnish:
                    var_t += 12
                elif not hifreq:
                    var_t += 8
            else:
                var_t = 16
            if do_psy & (K.PSY_CONTENT_ANALYSIS | K.PSY_ADAPTIVE_QUANT):
                luma_detail //= bw * bh
                keep_hf &= luma_detail < 48
                maintain = int(luma_detail < var_t * 4)
            if do_psy & K.PSY_CONTENT_ANALYSIS:
                if foliage:
                    keep_hf, maintain = 0, 1
                elif is_text:
                    keep_hf, maintain = 1, 0
            if do_psy & K.PSY_ADAPTIVE_RINGING:
                if luma_avg < 24:
                    ringing = True
            mf.set_bit(idx, K.MV_BIT_RINGING, int(ringing))
            mf.set_bit(idx, K.MV_BIT_MAINTAIN, int(bool(maintain)))
            mf.set_bit(idx, K.MV_BIT_SKIP, int(bool(keep_hf)))
    return mf


# ---------------------------------------------------------------------------
# device half (torch)
# ---------------------------------------------------------------------------

_I32 = torch.int32


def _sum(x, dims):
    return x.sum(dim=dims, dtype=_I32)


def _hist(bins):
    """(n, ...) int bins in [0, NHIST) -> (n, NHIST) int32 counts."""
    n = bins.shape[0]
    flat = bins.reshape(n, -1).to(torch.int64)
    out = torch.zeros((n, NHIST), dtype=_I32, device=bins.device)
    return out.scatter_add_(1, flat, torch.ones_like(flat, dtype=_I32))


def _features(blocks, gbw, gbh):
    """Block features over an (N, gbh, gbw) uint8 stack, C-exact int32."""
    n = blocks.shape[0]
    area = gbw * gbh
    pix = blocks.to(_I32)
    s = _sum(pix, (1, 2))
    sh = _sum((pix[:, :, 1:] - pix[:, :, :-1]).abs(), (1, 2))
    sv = _sum((pix[:, 1:, :] - pix[:, :-1, :]).abs(), (1, 2))
    avg = torch.div(s, area, rounding_mode="floor")
    var = _sum((pix - avg[:, None, None]).abs(), (1, 2))
    dvar = var >> 1
    tex = torch.maximum(sh, sv) - dvar
    detail = dvar + torch.clamp(tex, min=0)
    q4 = pix >> 4
    dh = q4[:, :, :-1] - q4[:, :, 1:]
    sh2 = _sum(dh * dh, (1, 2))
    dv = q4[:, 1:, :] - q4[:, :-1, :]
    sv2 = _sum(dv * dv, (1, 2))
    qtex = torch.div(isqrt_u32(torch.maximum(sh2, sv2)), avg2(gbw, gbh),
                     rounding_mode="floor")
    havg = torch.clamp(avg, min=1)
    quant16 = torch.div(torch.full_like(havg, (1 << (HISTBITS - 1)) << 16),
                        havg, rounding_mode="floor")
    hist = _hist(torch.clamp((pix * quant16[:, None, None]) >> 16,
                             0, NHIST - 1))
    hm = torch.div(_sum(hist, (1,)), NHIST, rounding_mode="floor")
    hd = hist - hm[:, None]
    hvar = torch.div(_sum(hd * hd, (1,)) * 256, NHIST * area * area,
                     rounding_mode="floor")
    w2, h2 = gbw // 2, gbh // 2
    ds = (pix[:, 0:2 * h2:2, 0:2 * w2:2] + pix[:, 0:2 * h2:2, 1:2 * w2:2]
          + pix[:, 1:2 * h2:2, 0:2 * w2:2]
          + pix[:, 1:2 * h2:2, 1:2 * w2:2] + 2) >> 2
    phst = _hist(torch.clamp((ds * quant16[:, None, None]) >> 16,
                             max=NHIST - 1))
    pavg = torch.div(_sum(phst, (1,)), NHIST, rounding_mode="floor")
    maxv = phst.amax(dim=1) >> 2
    edge = torch.full((n, 1), -1, dtype=_I32, device=phst.device)
    left = torch.cat([edge, phst[:, :-1]], dim=1)
    right = torch.cat([phst[:, 1:], edge], dim=1)
    is_peak = ((phst > left) & (phst > right)
               & ((phst > maxv[:, None]) | (phst > pavg[:, None])))
    return dict(detail=detail, avg=avg, var=var, tex=torch.maximum(sh, sv),
                qtex=qtex, hvar=hvar, npeaks=_sum(is_peak, (1,)))


def _group_flags(f, uavg, vavg, area, scale, do_psy):
    """(ringing, maintain, keep_hf) bool tensors from a feature dict +
    per-block chroma averages (twin: blockanalysis._group_flags with
    xp=jnp)."""
    detail = f["detail"]
    avg = f["avg"]
    n, dev = detail.shape[0], detail.device

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    ringing = torch.zeros(n, dtype=torch.bool, device=dev)
    foliage = torch.zeros(n, dtype=torch.bool, device=dev)
    is_text = torch.zeros(n, dtype=torch.bool, device=dev)
    var_t = torch.full((n,), 16, dtype=_I32, device=dev)
    if do_psy & (K.PSY_ADAPTIVE_RINGING | K.PSY_CONTENT_ANALYSIS):
        hvar, qtex, npeaks = f["hvar"], f["qtex"], f["npeaks"]
        luma_var = fdiv(f["var"], area)
        luma_tex = fdiv(f["tex"], area)
        is_text = (npeaks - 2).abs() <= 1
        tf2 = (((qtex == 1) | (qtex == 2)) & (hvar <= 3)
               & (luma_tex >= 10) & (luma_var >= luma_tex))
        tf = (((qtex == 2) | (qtex == 3)) & (luma_tex >= 8)
              & (luma_var >= 2 * luma_tex) & ((hvar - 5).abs() <= 3))
        is_text &= (tf | tf2)
        nature = (uavg < 128) & (vavg < 160)
        greyish = ((uavg - 128).abs() < 8) & ((vavg - 128).abs() < 8)
        skinnish = ((avg > 80) & (avg < 230) & ((uavg - 108).abs() < 24)
                    & ((vavg - 148).abs() < 24))
        hifreq = (uavg > 160) & ~greyish & ~skinnish
        foliage = nature & (avg < 160) & (detail
                                          > (36 * area) // max(scale, 1))
        is_text &= ~foliage
        ring_cond = foliage | ((hvar <= torch.clamp(qtex - 3, max=2) * 16)
                               & (qtex > 1))
        if do_psy & K.PSY_ADAPTIVE_RINGING:
            ringing = ~hifreq & ring_cond
        var_t = torch.where(nature | greyish | skinnish, 20,
                            torch.where(~hifreq, 16, 8)).to(_I32)
    maintain = torch.ones(n, dtype=torch.bool, device=dev)
    keep_hf = torch.ones(n, dtype=torch.bool, device=dev)
    if do_psy & (K.PSY_CONTENT_ANALYSIS | K.PSY_ADAPTIVE_QUANT):
        d = fdiv(detail, area)
        keep_hf &= d < 48
        maintain = d < var_t * 4
    if do_psy & K.PSY_CONTENT_ANALYSIS:
        keep_hf = torch.where(foliage, False,
                              torch.where(is_text, True, keep_hf))
        maintain = torch.where(foliage, True,
                               torch.where(is_text, False, maintain))
    if do_psy & K.PSY_ADAPTIVE_RINGING:
        ringing |= avg < 24
    return ringing, maintain, keep_hf


def device_intra_flags(pcfg):
    """Returns f(y, u, v) -> (ringing, maintain, keep_hf) bool tensors
    (B, nbv, nbh); y/u/v are the interior planes of B frames (B, ch, cw)
    uint8, coef dims from pcfg (rows past the visible height carry padding
    and are never read — blocks come from the visible region). Requires
    device_analysis_ok(pcfg)."""
    p = pcfg
    meta = p.meta
    bw, bh = p.blk_w, p.blk_h
    nbh, nbv = p.nbh, p.nbv
    hs, vs = K.fmt_h_shift(meta.subsamp), K.fmt_v_shift(meta.subsamp)
    scale = 2 * p.psyf_all
    do_psy = p.do_psy
    pw, ph = p.pdims[0]

    def chroma_avg(plane, nb, cy0, cx0, nj, ni, cbh, cbw):
        blk = plane[:, cy0:cy0 + nj * cbh, cx0:cx0 + ni * cbw]
        s = _sum(blk.reshape(nb, nj, cbh, ni, cbw), (2, 4))
        return torch.div(s, cbw * cbh, rounding_mode="floor").reshape(-1)

    def f(y, u, v):
        if not (y.dtype == u.dtype == v.dtype == torch.uint8):
            raise TypeError("planes must be uint8")
        nb = y.shape[0]
        ui, vi = u.to(_I32), v.to(_I32)
        grids = [torch.zeros((nb, nbv, nbh), dtype=torch.bool,
                             device=y.device) for _ in range(3)]
        for (j0, nj, i0, ni, gbw, gbh) in _grid_groups(pw, ph, bw, bh):
            y0, x0 = j0 * bh, i0 * bw
            blocks = (y[:, y0:y0 + nj * gbh, x0:x0 + ni * gbw]
                      .reshape(nb, nj, gbh, ni, gbw).permute(0, 1, 3, 2, 4)
                      .reshape(nb * nj * ni, gbh, gbw))
            ft = _features(blocks, gbw, gbh)
            cbw, cbh = gbw >> hs, gbh >> vs
            cy0, cx0 = (j0 * bh) >> vs, (i0 * bw) >> hs
            uavg = chroma_avg(ui, nb, cy0, cx0, nj, ni, cbh, cbw)
            vavg = chroma_avg(vi, nb, cy0, cx0, nj, ni, cbh, cbw)
            flags = _group_flags(ft, uavg, vavg, gbw * gbh, scale, do_psy)
            for g, fl in zip(grids, flags):
                g[:, j0:j0 + nj, i0:i0 + ni] = fl.reshape(nb, nj, ni)
        return tuple(grids)

    return f


def device_analysis_ok(pcfg):
    """True when the vectorized/device analysis applies (grouped fast
    path; tiny edge slivers stay on the scalar host path)."""
    p = pcfg
    return _vector_ok(p.pdims[0][0], p.pdims[0][1], p)
