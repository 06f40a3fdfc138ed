"""Per-block HVS intra analysis on the device, as torch ops.

Port of the device half of `dsv2_tpu/ops/blockanalysis.py`
(`device_intra_flags`, and `_group_flags` for torch tensors; ref:
src/hme.c:492-749, 1835-1971). The host half — `intra_analysis`, the
grid grouping and the preconditions — is jax-free and reused as it is.
Every reduction stays in int32 like the JAX twin (torch would promote to
int64), and the two 16-bin histograms are a scatter-add into
(nblocks, 16) rather than the twin's one-hot compare.
"""
import torch

from dsv2_tpu.core import constants as K
from dsv2_tpu.ops.blockanalysis import (HISTBITS, NHIST, _grid_groups, avg2,
                                        device_analysis_ok)  # noqa: F401

from .tint import isqrt_u32

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
