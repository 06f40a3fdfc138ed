"""HZCC adaptive quantization and dequantization as integer torch ops.

Port of `dsv2_tpu/ops/hzcc.py` (ref: src/hzcc.c:234-583). Within one subband every decision is elementwise
given the block-flag map, the already-dequantized parent subband and the
quantizer, and subbands run in a fixed order — so quantization is ten
vectorized passes over the coefficient plane, each over all frames of a
batch at once (leading frame dimension). The scan geometry helpers are
pure Python and identical to the twin's; they are ported because the
twin's module imports jax.

The twin is functional; make_quantize here works on a private copy of
the coefficients, written back in place subband by subband, and clones
every region it reads before a write-back (a torch slice is a view
where a JAX slice is a snapshot). The dequantizer (`make_dequantize`,
intra and P) is the decoder's.
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as K
from ..core import intmath as im

from . import tint
from .tint import on_device

MAXLVL = 3
MINQUANT = 8  # 1 << MINQP (ref: hzcc.c:33-34)
RUN_BITS = 24
EOP_SYMBOL = 0x55
LVL1, LVL2, LVL3 = 2, 1, 0
LH, HL, HH = 1, 2, 3


class HzccCfg(NamedTuple):
    w: int
    h: int
    is_luma: bool
    isP: bool
    lossless: bool
    nbh: int
    nbv: int
    blk_w: int
    blk_h: int
    vid_w: int        # video dims (for psy factor / mv cost scaling)
    vid_h: int
    subsamp: int
    do_psy: int


def spatial_psy_factor(cfg, subband):
    """Resolution-dependent psy factor (ref: hzcc.c:65-86). Static."""
    if subband == LH:
        lo = im.udiv_round_up(352, cfg.blk_w)
        hi = im.udiv_round_up(1920, cfg.blk_w)
        scale = cfg.nbh
    elif subband == HL:
        lo = im.udiv_round_up(288, cfg.blk_h)
        hi = im.udiv_round_up(1080, cfg.blk_h)
        scale = cfg.nbv
    else:
        lo = im.udiv_round_up(352, cfg.blk_w) * im.udiv_round_up(288, cfg.blk_h)
        hi = im.udiv_round_up(1920, cfg.blk_w) * im.udiv_round_up(1080, cfg.blk_h)
        scale = cfg.nbh * cfg.nbv
    scale = max(0, scale - lo)
    return (scale << 7) // (hi - lo)


def _floordiv(q, d):
    return torch.div(q, d, rounding_mode="floor")


def fix_quant(q):
    return _floordiv(q * 3, 2)


def lfquant(q, cfg):
    """LL quantizer (ref: hzcc.c:88-105); q an int32 tensor."""
    psyfac = spatial_psy_factor(cfg, HH)
    q = q - ((q * psyfac) >> (7 + 3))
    q = torch.clamp(q, min=MINQUANT)
    if not cfg.is_luma:
        q = torch.where(q > 256, 256 + _floordiv(q, 4), q)
        return torch.clamp(q, max=768)
    return torch.clamp(q, max=3072)


def hfquant(cfg, q, s, l):
    """High-frequency subband quantizer (ref: hzcc.c:107-162); q an int32
    tensor, s/l static."""
    chroma = not cfg.is_luma
    psy = spatial_psy_factor(cfg, s)
    q = _floordiv(q, 2)
    psyfac = (q * psy) >> (7 + (0 if cfg.isP else 1))
    if chroma:
        tl = l - 2
        if s == LH:
            tl += K.fmt_h_shift(cfg.subsamp)
        elif s == HL:
            tl += K.fmt_v_shift(cfg.subsamp)
        q = tint.divt(q * 6, 4 - tl)
    else:
        if l == LVL2:
            q = q + tint.divt(psyfac, 2)
        elif l == LVL1:
            q = q + psyfac
    if cfg.isP:
        if l != LVL1:
            if l == LVL3:
                q = q * 2 - psyfac
            else:
                q = q - tint.divt(psyfac, 2)
        return torch.clamp(tint.divt(q, 4), min=MINQUANT)
    q = tint.divt(q * (15 + 3 * l), 16)
    if not chroma:
        if l == LVL3:
            q = tint.divt(q * 3, 8)
        elif s == HH:
            q = q * 2
    else:
        q = tint.divt(q, 4)
        if s == HH:
            q = q * 2
    return torch.clamp(q, min=MINQUANT)


# --- per-coefficient quantizers (ref: hzcc.c:209-228) ---

def quant_sub(v, q, sub):
    return tint.divt(torch.where(v >= 0, v - sub, v + sub), q)


def quant_s(v, q):
    return tint.divt(v, q)


def dequant_s(v, q):
    t = tint.divt(q * 2, 3)
    return v * q + torch.where(v < 0, -t, t)


def dequant_d(v, q):
    t = _floordiv(q, 2)
    return v * q + torch.where(v < 0, -t, t)


def tmq4pos_p(tmq, flags, parc):
    """Adaptive quant from block flags, P frames (ref: hzcc.c:164-169)."""
    cond1 = (parc != 0) | ((flags & (K.IS_STABLE | K.IS_EPRM)) != 0)
    cond2 = (parc == 0) & ((flags & K.IS_INTRA) != 0)
    return torch.where(cond1, (tmq * 7) >> 3,
                       torch.where(cond2, (tmq * 6) >> 3, tmq))


def tmq4pos_i(tmq, flags, parc, l):
    """Adaptive quant from block flags, I frames (ref: hzcc.c:171-206)."""
    if l == MAXLVL - 3:
        return tmq
    smf = flags & (K.IS_STABLE | K.IS_MAINTAIN)
    ring = (flags & K.IS_RINGING) != 0
    notparc = (parc == 0).to(torch.int32)
    maintain_shift = torch.where(ring, 2, notparc)
    if l == MAXLVL - 2:
        t_stable = tint.divt(tmq, 3)
        t_both = tmq >> 2
    else:  # MAXLVL - 1
        t_stable = tmq >> 2
        t_both = tmq >> (2 + notparc)
    t_maint = tmq >> maintain_shift
    return torch.where(
        smf == K.IS_STABLE, t_stable,
        torch.where(smf == K.IS_MAINTAIN, t_maint,
                    torch.where(smf == (K.IS_MAINTAIN | K.IS_STABLE),
                                t_both, tmq)))


# --- static scan geometry ---

def _dimat(l, v):
    return im.round_shift(v, MAXLVL - l)


def _suboff(l, s, w, h):
    off_c = _dimat(l, w) if (s & 1) else 0
    off_r = _dimat(l, h) if (s & 2) else 0
    return off_r, off_c


@functools.lru_cache(maxsize=None)
def subband_plan(w, h):
    """[(l, s, row0, col0, sw, sh)] for the 9 HF subbands, scan order."""
    plan = []
    for l in range(MAXLVL):
        sw, sh = _dimat(l, w), _dimat(l, h)
        for s in (1, 2, 3):
            r0, c0 = _suboff(l, s, w, h)
            assert r0 + sh <= h and c0 + sw <= w, (w, h, l, s)
            plan.append((l, s, r0, c0, sw, sh))
    return plan


@functools.lru_cache(maxsize=None)
def scan_segments(w, h):
    """Segments for the entropy scan: [(count, damp)] with the LL segment
    damp = -1 (NEG coded); damp = 3 + l for HF (ref: hzcc.c:230)."""
    sw0, sh0 = _dimat(0, w), _dimat(0, h)
    segs = [(sw0 * sh0, -1)]
    for (l, s, r0, c0, sw, sh) in subband_plan(w, h):
        segs.append((sw * sh, 3 + l))
    return segs


def total_scan_coefs(w, h):
    return sum(c for c, _ in scan_segments(w, h))


@functools.lru_cache(maxsize=None)
def _block_gather(sw, sh, nbh, nbv):
    """Block index per coefficient of an (sh, sw) subband
    (ref: hzcc.c:336-337,354-361)."""
    dbx = (nbh << K.BLOCK_INTERP_P) // sw
    dby = (nbv << K.BLOCK_INTERP_P) // sh
    by = (np.arange(sh) * dby) >> K.BLOCK_INTERP_P
    bx = (np.arange(sw) * dbx) >> K.BLOCK_INTERP_P
    return by, bx


def _flags_map(blockdata, sw, sh, nbh, nbv):
    by, bx = on_device(blockdata.device, _block_gather, sw, sh, nbh, nbv)
    return blockdata[..., by[:, None], bx[None, :]].to(torch.int32)


@functools.lru_cache(maxsize=None)
def _parent_idx(l, s, w, h, sw, sh, generations):
    r0, c0 = _suboff(l - generations, s, w, h)
    ys = r0 + (np.arange(sh) >> generations)
    xs = c0 + (np.arange(sw) >> generations)
    return ys, xs


def _parent_vals(x, l, s, w, h, sw, sh, generations):
    ys, xs = on_device(x.device, _parent_idx, l, s, w, h, sw, sh,
                       generations)
    return x[..., ys[:, None], xs[None, :]]


@functools.lru_cache(maxsize=None)
def _self_parent_mask(w, h, l, s):
    """Cells of subband (l,s) whose parent gather lands INSIDE the subband
    itself. At non-multiple-of-16 dims the fixed 3-level scan regions overlap
    by one row/column, and the reference's serial scan reads parent values it
    has just rewritten (ref: hzcc.c:352-437 flat-memory traversal). These
    cells need a second vectorized pass with post-writeback parents. Returns
    None when the mask is empty (all standard resolutions)."""
    r0, c0 = _suboff(l, s, w, h)
    sw, sh = _dimat(l, w), _dimat(l, h)
    pr0, pc0 = _suboff(l - 1, s, w, h)
    pr = pr0 + (np.arange(sh) >> 1)
    pc = pc0 + (np.arange(sw) >> 1)
    row_in = (pr >= r0) & (pr < r0 + sh)
    col_in = (pc >= c0) & (pc < c0 + sw)
    m = row_in[:, None] & col_in[None, :]
    if not m.any():
        return None
    # a cell whose "parent" is ITSELF (saturated ceil-halving at degenerate
    # dims) must keep its first-pass value: the reference's serial scan
    # reads the pre-write slot there (0 on decode, the original coef on
    # encode), so the rewrite passes below exclude it
    row_eq = pr == (r0 + np.arange(sh))
    col_eq = pc == (c0 + np.arange(sw))
    m &= ~(row_eq[:, None] & col_eq[None, :])
    return m if m.any() else None


# --- encoder quantize + in-loop dequant writeback ---

@functools.lru_cache(maxsize=None)
def make_quantize(cfg: HzccCfg):
    """Returns fn(coefs int32[..., h, w], blockdata uint8[..., nbv, nbh],
    q int32[...], eprm_m=None, maintlt_m=None) -> (dequantized coefs
    int32[..., h, w], v_scan int32[..., total]), one quantizer per frame.
    eprm_m / maintlt_m are the (..., nbv, nbh) bool maps from the motion
    field that P frames need (psy masking; ref: hzcc.c:369-380); intra
    frames take neither. The twin passes them before q."""
    w, h = cfg.w, cfg.h
    sw0, sh0 = _dimat(0, w), _dimat(0, h)
    psy_i = bool(cfg.do_psy & K.PSY_I_VISUAL_MASKING) and cfg.is_luma
    psy_p = bool(cfg.do_psy & K.PSY_P_VISUAL_MASKING) and cfg.is_luma

    def quant_p(xcur, blockdata, q, sub, l, s, sw, sh, eprm_m, maintlt_m):
        qp = hfquant(cfg, q, s, l)
        flags = _flags_map(blockdata, sw, sh, cfg.nbh, cfg.nbv)
        parc = _parent_vals(xcur, l, s, w, h, sw, sh, 1)
        tmq = tmq4pos_p(qp, flags, parc)
        if not psy_p:
            return quant_s(sub, tmq), tmq
        gparc = _parent_vals(xcur, l, s, w, h, sw, sh, 2)
        by, bx = on_device(blockdata.device, _block_gather, sw, sh, cfg.nbh,
                           cfg.nbv)
        eprm = eprm_m[..., by[:, None], bx[None, :]]
        mlt = maintlt_m[..., by[:, None], bx[None, :]]
        simc = (flags & K.IS_SIMCMPLX) != 0
        texture = parc == 0
        c1 = (texture & (gparc == 0)) | eprm | mlt
        c2 = texture | ~simc
        v = torch.where(
            c1, quant_sub(sub, tmq, tmq >> 3),
            torch.where(c2, quant_sub(sub, tmq, tint.divt(tmq, 6)),
                        quant_sub(sub, tmq, tmq >> 2)))
        return v, tmq

    def quant_one(xcur, blockdata, q, sub, l, s, sw, sh, *masks):
        """v and tmq for one subband given the current plane state."""
        if cfg.isP:
            return quant_p(xcur, blockdata, q, sub, l, s, sw, sh, *masks)
        qp = hfquant(cfg, q, s, l)
        flags = _flags_map(blockdata, sw, sh, cfg.nbh, cfg.nbv)
        parc = _parent_vals(xcur, l, s, w, h, sw, sh, 1)
        tmq = tmq4pos_i(qp, flags, parc, l)
        if psy_i:
            ring = (flags & K.IS_RINGING) != 0
            if l == LVL3:
                v_nr = quant_sub(sub, tmq, -(tmq >> 3))
            else:
                edge = torch.sign(parc) == torch.sign(sub)
                smf = flags & (K.IS_MAINTAIN | K.IS_STABLE)
                stp = torch.where(
                    smf == 0, -tint.divt(tmq, 3),
                    torch.where(edge & (smf == K.IS_STABLE), tmq >> 3,
                                -tint.divt(tmq, 6)))
                v_nr = quant_sub(sub, tmq, stp)
            v = torch.where(ring, quant_sub(sub, tmq, -tint.divt(tmq, 6)),
                            v_nr)
        elif not cfg.is_luma:
            v = quant_sub(sub, tmq, -(tmq >> 3))
        else:
            v = quant_s(sub, tmq)
        return v, tmq

    def f(x, blockdata, q, eprm_m=None, maintlt_m=None):
        if (x.dtype != torch.int32 or blockdata.dtype != torch.uint8
                or q.dtype != torch.int32):
            raise TypeError("coefs/q must be int32 and blockdata uint8")
        masks = ()
        if cfg.isP:
            if eprm_m is None or maintlt_m is None:
                raise ValueError("P-frame quantization needs eprm_m and "
                                 "maintlt_m")
            masks = (eprm_m.to(torch.bool), maintlt_m.to(torch.bool))
        lead = x.shape[:-2]
        x = x.clone()
        ll_save = x[..., 0, 0].clone()
        # zero_(), not `= 0`: one frame's view is 0-dim, and a Python
        # scalar stored into a 0-dim CUDA tensor is a host copy that waits
        x[..., 0, 0].zero_()
        q = fix_quant(q)[..., None, None]
        vs = []
        # LL subband (ref: hzcc.c:307-328 / lossless 268-281)
        qp = lfquant(q, cfg)
        ll = x[..., :sh0, :sw0].clone()
        if cfg.lossless:
            v = ll
        elif cfg.isP:
            v = quant_s(ll, qp)
            x[..., :sh0, :sw0] = torch.where(v != 0, dequant_d(v, qp), 0)
        else:
            v = quant_sub(ll, qp, -_floordiv(qp, 6))
            x[..., :sh0, :sw0] = torch.where(v != 0, dequant_s(v, qp), 0)
        vs.append(v.reshape(lead + (-1,)))
        for (l, s, r0, c0, sw, sh) in subband_plan(w, h):
            sub = x[..., r0:r0 + sh, c0:c0 + sw].clone()
            if cfg.lossless:
                vs.append(sub.reshape(lead + (-1,)))
                continue
            v, tmq = quant_one(x, blockdata, q, sub, l, s, sw, sh, *masks)
            x[..., r0:r0 + sh, c0:c0 + sw] = torch.where(
                v != 0, dequant_d(v, tmq), 0)
            m = _self_parent_mask(w, h, l, s)
            if m is not None:
                # serial-scan fixup: cells whose parent lives in this very
                # subband requantize against the freshly written values.
                # Parents form >>1 chains up to log2(dim) deep; each pass
                # finalizes one more generation (the quantized value feeds
                # the child's parc-zeroness test, so encoder chains can
                # propagate further than one rewrite)
                m = on_device(x.device, _self_parent_mask, w, h, l, s)
                for _ in range(max(sw, sh).bit_length()):
                    v2, tmq2 = quant_one(x, blockdata, q, sub, l, s, sw, sh,
                                         *masks)
                    v = torch.where(m, v2, v)
                    fixed = torch.where(v != 0, dequant_d(v, tmq2), 0)
                    cur = x[..., r0:r0 + sh, c0:c0 + sw]
                    x[..., r0:r0 + sh, c0:c0 + sw] = torch.where(m, fixed,
                                                                 cur)
            vs.append(v.reshape(lead + (-1,)))
        x[..., 0, 0] = ll_save
        return x, torch.cat(vs, dim=-1)

    return f


@functools.lru_cache(maxsize=None)
def make_dequantize(cfg: HzccCfg):
    """Returns fn(v_scan int32[..., total], blockdata uint8[..., nbv, nbh],
    q int32[...], ll_value int32[...]) -> coef plane int32[..., h, w]; one
    quantizer and DC value per frame. Decoder-side counterpart of
    make_quantize (ref: hzcc.c:450-583): positions without a coded value
    stay zero; overlapping subband cells resolve in scan order."""
    w, h = cfg.w, cfg.h
    sw0, sh0 = _dimat(0, w), _dimat(0, h)

    def f(v_scan, blockdata, q, ll_value):
        if (v_scan.dtype != torch.int32 or blockdata.dtype != torch.uint8
                or q.dtype != torch.int32 or ll_value.dtype != torch.int32):
            raise TypeError("v_scan/q/ll_value must be int32 and blockdata "
                            "uint8")
        lead = v_scan.shape[:-1]
        q = fix_quant(q)[..., None, None]
        x = torch.zeros(lead + (h, w), dtype=torch.int32,
                        device=v_scan.device)
        pos = sw0 * sh0
        v = v_scan[..., :pos].reshape(lead + (sh0, sw0))
        if cfg.lossless:
            x[..., :sh0, :sw0] = v
        else:
            qp = lfquant(q, cfg)
            deq = dequant_d(v, qp) if cfg.isP else dequant_s(v, qp)
            x[..., :sh0, :sw0] = torch.where(v != 0, deq, 0)
        for (l, s, r0, c0, sw, sh) in subband_plan(w, h):
            v = v_scan[..., pos:pos + sw * sh].reshape(lead + (sh, sw))
            pos += sw * sh
            cur = x[..., r0:r0 + sh, c0:c0 + sw]
            if cfg.lossless:
                x[..., r0:r0 + sh, c0:c0 + sw] = torch.where(v != 0, v, cur)
                continue

            def deq_one(xcur):
                qp = hfquant(cfg, q, s, l)
                flags = _flags_map(blockdata, sw, sh, cfg.nbh, cfg.nbv)
                parc = _parent_vals(xcur, l, s, w, h, sw, sh, 1)
                if cfg.isP:
                    tmq = tmq4pos_p(qp, flags, parc)
                else:
                    tmq = tmq4pos_i(qp, flags, parc, l)
                return dequant_d(v, tmq)

            x[..., r0:r0 + sh, c0:c0 + sw] = torch.where(v != 0, deq_one(x),
                                                         cur)
            if _self_parent_mask(w, h, l, s) is not None:
                # decode-side parc only matters through zeroness, which one
                # rewrite finalizes (zeroness = v != 0, fixed after pass 1)
                m = on_device(x.device, _self_parent_mask, w, h, l, s)
                cur2 = x[..., r0:r0 + sh, c0:c0 + sw]
                out2 = torch.where(v != 0, deq_one(x), cur2)
                x[..., r0:r0 + sh, c0:c0 + sw] = torch.where(m, out2, cur2)
        x[..., 0, 0] = ll_value
        return x

    return f
