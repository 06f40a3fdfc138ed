"""Multiresolution subband transform (analysis + synthesis) as integer
torch ops.

Port of `dsv2_tpu/ops/sbt.py` (ref: src/sbt.c).
Each level's separable lifting filter runs on the last axis of a
(..., m, n) tensor, every row or column at once; a leading frame
dimension rides along. All arithmetic is int32 with C-exact truncating
division and arithmetic shifts, so coefficients are bit-identical to
`dsv2_tpu` and the reference.

Filter selection per level (ref: sbt.c:19-29, 862-885): L1 luma (ASF93),
L2A luma (adaptive 5-tap + SHREX), LLI luma level 4, CC chroma mid
levels, LLP luma P level 4, LOSSLESS mid levels, Haar elsewhere (the
inverse adds the gradient-nudging "filtered" Haar). The forward P
transform raises (P encode, ROADMAP item 14); the decoder-arena inverse
`make_inv_sbt_arena` is not ported (ROADMAP item 18).

The JAX twin is functional (`x.at[...].set`); here each transform works
on a private int32 copy of its input and updates it in place level by
level, and the scratch-row carry is updated in place too. Regions read
before a write-back are cloned (a torch slice is a view).
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as K
from ..core import intmath as im

from . import tint
from .tint import on_device

# --- filter constants (wire format, ref: sbt.c:127-257) ---
CC0, CCS = 3, 4
CCA = 1 << (CCS - 1)
R20, R2S = 3, 3
R2A = 1 << (R2S - 1)
S20, S2S = 9, 5
S2A = 1 << (S2S - 1)
SHREX2 = 3
ASF_LPF = (46, 19, -8, -3, 1)      # center, +-1, +-2, +-3, +-4
ASF_LPF_R = (46, 20, -9, -4, 2)
ASF_HPA, ASF_HPB = 32, 16
ASFNORM = 6


class SbtCfg(NamedTuple):
    cw: int            # coefficient-plane width  (>= visible plane width)
    ch: int            # coefficient-plane height
    is_luma: bool
    isP: bool
    lossless: bool
    nbh: int           # block grid dims (for adaptive filters)
    nbv: int

    @property
    def lvls(self):
        return im.nlevels(self.cw, self.ch)


def _reflect(i, n):
    """ref: sbt.c:105-115 (called with n-1)."""
    i = np.abs(np.asarray(i))
    return np.where(i >= n, n + n - i, i)


def _zcol(o):
    return torch.zeros(o.shape[:-1] + (1,), dtype=o.dtype, device=o.device)


# ---------------------------------------------------------------------------
# 1-D lifting steps along the last axis of a (..., m, n) tensor.
# e = even samples (lows-to-be), o = odd samples (highs-to-be).
# ---------------------------------------------------------------------------

def _hi3_upd(e, n):
    """Update term for all floor(n/2) odd samples (ref: sbt.c:191-197)."""
    if n % 2:
        return (e[..., :-1] + e[..., 1:] + 1) >> 1
    if n == 2:
        return e[..., -1:]
    std = (e[..., :-1] + e[..., 1:] + 1) >> 1
    return torch.cat([std, e[..., -1:]], dim=-1)


def _lo3_upd(o, n):
    """Update term for even samples; zero beyond last pair (ref: sbt.c:199-203)."""
    ne, no = n - n // 2, n // 2
    parts = [o[..., :1] >> 1]
    if no > 1:
        parts.append((o[..., :-1] + o[..., 1:] + 2) >> 2)
    if ne > no:
        parts.append(_zcol(o))
    return torch.cat(parts, dim=-1)


@functools.lru_cache(maxsize=None)
def _lo5_idx(n):
    no = n // 2
    k = np.arange(1, no)
    il = _reflect(2 * k - 3, n - 1)
    ir = _reflect(2 * k + 3, n - 1)
    return (il - 1) // 2, (ir - 1) // 2


def _lo5_mid(o, n, c0, ca, cs):
    li, ri = on_device(o.device, _lo5_idx, n)
    no = n // 2
    return (-o[..., li] + c0 * (o[..., 0:no - 1] + o[..., 1:no])
            - o[..., ri] + ca) >> cs


def _lo5_upd(o, n, c0, ca, cs):
    """5-tap low-pass update with edge reflection (ref: sbt.c:216-225)."""
    ne, no = n - n // 2, n // 2
    parts = [o[..., :1] >> 1]
    if no > 1:
        parts.append(_lo5_mid(o, n, c0, ca, cs))
    if ne > no:
        parts.append(_zcol(o))
    return torch.cat(parts, dim=-1)


def _lo5a_upd(o, n, ring):
    """Adaptive 5-tap: ringing coefs where the block is marked RINGING
    (ref: sbt.c:227-238). ring has shape (..., m, floor(n/2)-1)."""
    ne, no = n - n // 2, n // 2
    parts = [o[..., :1] >> 1]
    if no > 1:
        std = _lo5_mid(o, n, S20, S2A, S2S)
        rng = _lo5_mid(o, n, R20, R2A, R2S)
        parts.append(torch.where(ring, rng, std))
    if ne > no:
        parts.append(_zcol(o))
    return torch.cat(parts, dim=-1)


def _interleave(e, o, n):
    out = torch.zeros(e.shape[:-1] + (n,), dtype=e.dtype, device=e.device)
    out[..., 0::2] = e
    out[..., 1::2] = o
    return out


# --- forward/inverse scale pairs (C truncating division; ref: sbt.c:33-43) ---
_FS = {
    "52": lambda x: tint.divt(x * 5, 2), "i52": lambda x: tint.divt(x * 2, 5),
    "20": lambda x: x * 2, "i20": lambda x: tint.divt(x, 2),
    "40": lambda x: x * 4, "i40": lambda x: tint.divt(x, 4),
    "no": lambda x: x, "ino": lambda x: x,
}


def _shrex_fwd(o):
    th = o * 3
    return th - (th >> SHREX2)


def _shrex_inv(x):
    th = tint.divt(x, 3)
    return th + (th >> SHREX2)


def _fwd_lift(x, n, lo_fn, scale_l, scale_h):
    """(lifted, post-lift UNSCALED odd samples). The reference mutates its
    temp buffer in place before SCALE_PACK, so temp row 1 after a column
    pass equals o[..., 0] — the value the degenerate sh==1 levels later
    read; see _filter_2d_fwd."""
    e, o = x[..., 0::2], x[..., 1::2]
    o = o - _hi3_upd(e, n)
    e = e + lo_fn(o)
    return torch.cat([scale_l(e), scale_h(o)], dim=-1), o


def _inv_lift(x, n, lo_fn, iscale_l, iscale_h):
    ne = n - n // 2
    e = iscale_l(x[..., :ne])
    o = iscale_h(x[..., ne:])
    e = e - lo_fn(o)
    o = o + _hi3_upd(e, n)
    return _interleave(e, o, n)


# --- ASF93 forward (L1, even n only; ref: sbt.c:384-421) ---

@functools.lru_cache(maxsize=None)
def _asf_idx(n):
    t = np.arange(0, n // 2 - 1)  # i = 2t+1, center c = i-1 = 2t
    d = np.arange(-4, 5)[:, None]
    return _reflect(2 * t[None, :] + d, n - 1)


def _fwd_l1(x, n, ring):
    """ring: (..., m, n//2 - 1) bool for loop positions t."""
    no = n // 2
    g = x[..., on_device(x.device, _asf_idx, n)]  # (..., m, 9, no-1)

    def lpf(coefs):
        a, b, c, dd, e = coefs
        return (a * g[..., 4, :]
                + b * (g[..., 3, :] + g[..., 5, :])
                + c * (g[..., 2, :] + g[..., 6, :])
                + dd * (g[..., 1, :] + g[..., 7, :])
                + e * (g[..., 0, :] + g[..., 8, :]))

    L = torch.where(ring, lpf(ASF_LPF_R), lpf(ASF_LPF))
    xi = x[..., 1:n - 2:2]
    H = ASF_HPA * xi - ASF_HPB * (x[..., 0:n - 3:2] + x[..., 2:n - 1:2])
    lows_mid = (L + (1 << (ASFNORM - 2))) >> (ASFNORM - 1)
    highs_mid = (H + (1 << (ASFNORM - 4))) >> (ASFNORM - 3)

    # edge lifting on the original samples (ref: sbt.c:406-420)
    x1 = x[..., 1:2] - ((x[..., 0:1] + x[..., 2:3] + 1) >> 1)
    xn3 = x[..., n - 3:n - 2] - ((x[..., n - 4:n - 3]
                                  + x[..., n - 2:n - 1] + 1) >> 1)
    xn1 = x[..., n - 1:n] - x[..., n - 2:n - 1]
    x0 = x[..., 0:1] + (x1 >> 1)
    xn2 = x[..., n - 2:n - 1] + ((xn3 + xn1 + 2) >> 2)

    lows = torch.cat([x0 * 2, lows_mid[..., 1:], xn2 * 2], dim=-1)
    highs = torch.cat([x1 * 4, highs_mid[..., 1:], xn1 * 4], dim=-1)
    assert lows.shape[-1] == no and highs.shape[-1] == no
    return torch.cat([lows, highs], dim=-1)


# ---------------------------------------------------------------------------
# Haar quadrant level (ref: sbt.c:546-612)
# ---------------------------------------------------------------------------

def _haar_fwd(sub, hs, ws, ovf):
    he, we = hs // 2, ws // 2
    hc, wc = hs - he, ws - we
    x0 = sub[..., 0::2, 0::2]
    x1 = sub[..., 0::2, 1::2]
    x2 = sub[..., 1::2, 0::2]
    x3 = sub[..., 1::2, 1::2]
    x0m = x0[..., :he, :we]
    x1m = x1[..., :he, :]
    x2m = x2[..., :, :we]

    ll = x0m + x1m + x2m + x3
    lh = x0m - x1m + x2m - x3
    hl = x0m + x1m - x2m - x3
    hh = x0m - x1m - x2m + x3
    if wc > we:  # odd width column
        ll = torch.cat([ll, 2 * (x0[..., :he, we:] + x2[..., :, we:])], -1)
        hl = torch.cat([hl, 2 * (x0[..., :he, we:] - x2[..., :, we:])], -1)
    if hc > he:  # odd height row
        llr = 2 * (x0[..., he:, :we] + x1[..., he:, :])
        lhr = 2 * (x0[..., he:, :we] - x1[..., he:, :])
        if wc > we:
            llr = torch.cat([llr, 4 * x0[..., he:, we:]], dim=-1)
        ll = torch.cat([ll, llr], dim=-2)
        lh = torch.cat([lh, lhr], dim=-2)
    if ovf:
        ll = tint.divt(ll, 2)
    top = torch.cat([ll, lh], dim=-1)
    bot = torch.cat([hl, hh], dim=-1)
    return torch.cat([top, bot], dim=-2)


# ---------------------------------------------------------------------------
# Haar inverse levels (ref: sbt.c:614-682, 684-795)
# ---------------------------------------------------------------------------

def _haar_quads(sub, hs, ws, ovf):
    """Quadrants of an (..., hs, ws) sub-image; ll is new, lh/hl/hh are
    clones (callers update them in place)."""
    he, we = hs // 2, ws // 2
    hc, wc = hs - he, ws - we
    ll = sub[..., :hc, :wc] * (1 << ovf)
    lh = sub[..., :hc, wc:].clone()
    hl = sub[..., hc:, :wc].clone()
    hh = sub[..., hc:, wc:].clone()
    return ll, lh, hl, hh, he, we, hc, wc


def _zpad(a, rows, cols):
    """a with `rows` zero rows and `cols` zero columns appended."""
    if cols:
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (cols,))], dim=-1)
    if rows:
        a = torch.cat([a, a.new_zeros(a.shape[:-2] + (rows, a.shape[-1]))],
                      dim=-2)
    return a


def _haar_recombine(ll, lh, hl, hh, hs, ws, he, we, hc, wc):
    # zero-pad quadrants to (hc, wc); odd row/col formulas then fall out
    lh = _zpad(lh, 0, wc - we)
    hl = _zpad(hl, hc - he, 0)
    hh = _zpad(hh, hc - he, wc - we)
    a = tint.divt(ll + lh + hl + hh, 4)
    b = tint.divt(ll - lh + hl - hh, 4)[..., :, :we]
    c = tint.divt(ll + lh - hl - hh, 4)[..., :he, :]
    d = tint.divt(ll - lh - hl + hh, 4)[..., :he, :we]
    out = torch.zeros(ll.shape[:-2] + (hs, ws), dtype=ll.dtype,
                      device=ll.device)
    out[..., 0::2, 0::2] = a
    out[..., 0::2, 1::2] = b
    out[..., 1::2, 0::2] = c
    out[..., 1::2, 1::2] = d
    return out


def _haar_inv_simple(sub, hs, ws, ovf):
    ll, lh, hl, hh, he, we, hc, wc = _haar_quads(sub, hs, ws, ovf)
    return _haar_recombine(ll, lh, hl, hh, hs, ws, he, we, hc, wc)


def _nudge(center, lp, ln, hf, hqp):
    """Gradient-consistency nudge of an HF coef (ref: sbt.c:723-741).
    hqp broadcasts against the coefficient arrays."""
    mx = center - ln
    mn = lp - center
    # after the reference's ordering swap: lower = min(max(mn,mx), 0),
    # upper = max(min(mn,mx), 0)
    lo = torch.clamp(torch.maximum(mn, mx), max=0)
    hi = torch.clamp(torch.minimum(mn, mx), min=0)
    t = tint.round4(lp - ln)
    nud = tint.round2(torch.minimum(torch.maximum(t, lo), hi) - hf * 2)
    upd = hf + torch.minimum(torch.maximum(nud, -hqp), hqp)
    return torch.where(lo != hi, upd, hf)


def _haar_inv_filtered(x, hs, ws, ovf, hqp):
    """Haar filtered inverse: nudges LH along x-gradients of LL and HL along
    y-gradients before recombination (ref: sbt.c:686-795). Neighbor reads
    intentionally cross the subband boundary exactly like the reference's
    flat-memory indexing does. hqp: int32 (..., 1, 1), one per frame."""
    sub = x[..., :hs, :ws]
    ll, lh, hl, hh, he, we, hc, wc = _haar_quads(sub, hs, ws, ovf)
    if we > 0 and he > 0:
        # horizontal pass on LH (main region rows :he, cols 1..we-1)
        llm = ll[..., :he, :we]
        # neighbors from raw memory layout (may read first LH/HL element)
        lp = sub[..., :he, 0:we - 1] * (1 << ovf)    # spLL[idx-1], idx=1..we-1
        ln = sub[..., :he, 2:we + 1] * (1 << ovf)    # spLL[idx+1]
        lh[..., :he, 1:we] = _nudge(llm[..., :, 1:], lp, ln,
                                    lh[..., :he, 1:we], hqp)
        # vertical pass on HL (rows 1..he-1, all cols :we)
        if he > 1:
            lpv = sub[..., 0:he - 1, :we] * (1 << ovf)
            lnv = sub[..., 2:he + 1, :we] * (1 << ovf)
            hl[..., 1:he, :we] = _nudge(llm[..., 1:, :], lpv, lnv,
                                        hl[..., 1:he, :we], hqp)
    return _haar_recombine(ll, lh, hl, hh, hs, ws, he, we, hc, wc)


# ---------------------------------------------------------------------------
# Per-level plans
# ---------------------------------------------------------------------------

def _kind(cfg, l):
    lvls = cfg.lvls
    if cfg.lossless:
        return "lossless" if 1 <= l <= lvls - 2 else "haar"
    if cfg.is_luma and not cfg.isP and l == 4:
        return "lli"
    if cfg.is_luma and cfg.isP and l == 4:
        return "llp"
    if not cfg.is_luma and not cfg.isP and 1 <= l <= lvls - 2:
        return "cc"
    if cfg.is_luma and not cfg.isP and l == 2:
        return "l2a"
    if cfg.is_luma and not cfg.isP and l == 1:
        return "l1"
    return "haar"


def _ovf(cfg, l):
    return int(l >= 6 and l >= cfg.lvls - 3 and not cfg.lossless)


_LIFT = {
    # kind -> (lo_fn_builder, scaleL, scaleH); the inverse scales are the
    # "i"-prefixed entries of _FS
    "lli": (lambda n: lambda o: _lo3_upd(o, n), "52", "40"),
    "llp": (lambda n: lambda o: _lo3_upd(o, n), "52", "20"),
    "cc": (lambda n: lambda o: _lo5_upd(o, n, CC0, CCA, CCS), "20", "no"),
    "lossless": (lambda n: lambda o: _lo3_upd(o, n), "no", "no"),
}


@functools.lru_cache(maxsize=None)
def _ring_idx(nb_perp, nb_along, s_perp, s_along):
    """Static gather indices stretching the block grid over a sub-image:
    perpendicular (per processed row) and along (per filter position)
    (ref: sbt.c:474-521, fixed point DSV_BLOCK_INTERP_P)."""
    d_perp = (nb_perp << K.BLOCK_INTERP_P) // s_perp
    d_along = (nb_along << K.BLOCK_INTERP_P) // s_along
    rows = (np.arange(s_perp) * d_perp) >> K.BLOCK_INTERP_P
    npos = max(s_along // 2 - 1, 0)
    cols = (np.arange(npos) * 2 * d_along) >> K.BLOCK_INTERP_P
    return rows, cols


def _ring_mask(blockdata, cfg, sw, sh, axis):
    """Ringing-block mask (..., m, npos) for a row (axis=1) or column
    (axis=0) filter pass; blockdata is (..., nbv, nbh)."""
    if axis == 1:   # filtering along x; one line per row j
        rows, cols = on_device(blockdata.device, _ring_idx,
                               cfg.nbv, cfg.nbh, sh, sw)
        m = blockdata[..., rows[:, None], cols[None, :]]
    else:           # filtering along y; one line per column i
        rows, cols = on_device(blockdata.device, _ring_idx,
                               cfg.nbh, cfg.nbv, sw, sh)
        m = blockdata[..., cols[None, :], rows[:, None]]
    return (m & K.IS_RINGING) != 0


def _filter_2d_fwd(x, cfg, l, kind, blockdata, carry):
    """One fwd_2d level, in place on x (..., ch, cw) and carry (..., cw).
    `carry` models the reference's temp-buffer row 1 (ref: sbt.c:449-459
    fwd_2d over a shared scratch): at degenerate levels (sub height 1,
    reachable for CC/lossless when the aspect ratio is extreme) the n==1
    low-pass update `v[0] += v[s] >> 1` reads the scratch row the LAST
    level with sub height >= 2 left behind — that deterministic staleness
    is part of the bitstream (sbt.c:199-225). Likewise a sub width of 1
    reads the coefficient buffer's column 1."""
    w, h = cfg.cw, cfg.ch
    sw, sh = im.round_shift(w, l - 1), im.round_shift(h, l - 1)
    sub = x[..., :sh, :sw]

    def run(arr, n, axis):
        """(lifted lines, post-lift odd samples or None)."""
        if kind == "l1":
            return _fwd_l1(arr, n, _ring_mask(blockdata, cfg, sw, sh,
                                              axis)), None
        if kind == "l2a":
            ring = _ring_mask(blockdata, cfg, sw, sh, axis)
            out, _ = _fwd_lift(arr, n, lambda o: _lo5a_upd(o, n, ring),
                               _FS["20"], _shrex_fwd)
            return out, None
        lo_b, sl, shh = _LIFT[kind]
        return _fwd_lift(arr, n, lo_b(n), _FS[sl], _FS[shh])

    scale_l = _FS[_LIFT[kind][1]] if kind in _LIFT else None
    if sw == 1:
        # row pass n==1: v[0] += coef[j][1] >> 1 then scaleL (the read is
        # from the coefficient buffer, one past the sub-image)
        nb = (x[..., :sh, 1] >> 1) if w > 1 else 0
        r = scale_l(sub[..., :, 0] + nb)[..., None]
    else:
        r, _ = run(sub, sw, axis=1)

    if sh == 1:
        # column pass n==1: lift against the stale scratch row 1, scaleL;
        # the carry itself is NOT rewritten (row passes at sub height 1
        # only touch scratch row 0)
        out = scale_l(r[..., 0, :] + (carry[..., :sw] >> 1))[..., None, :]
    else:
        out, o_col = run(r.transpose(-1, -2), sh, axis=0)
        out = out.transpose(-1, -2)
        if o_col is not None:
            # scratch row 1 after this level's column lifts (pre-scale)
            carry[..., :sw] = o_col[..., 0]
    x[..., :sh, :sw] = out


def _filter_2d_inv(x, cfg, l, kind, blockdata, stale):
    """One inv_2d level, in place on x (..., ch, cw). `stale` models the
    reference's scratch row 1 at this point of the inverse (ref:
    sbt.c:461-473): the inverse runs levels high-to-low, so its
    degenerate (sub height 1) levels run FIRST and read whatever the
    preceding transform left in scratch row 1 — the forward pass of the
    same plane for the encoder's in-loop inverse; None reads zeros."""
    w, h = cfg.cw, cfg.ch
    sw, sh = im.round_shift(w, l - 1), im.round_shift(h, l - 1)
    sub = x[..., :sh, :sw]

    def run(arr, n, axis):
        if kind == "l1":
            return _inv_lift(arr, n, lambda o: _lo3_upd(o, n),
                             _FS["i20"], _FS["i40"])
        if kind == "l2a":
            ring = _ring_mask(blockdata, cfg, sw, sh, axis)
            return _inv_lift(arr, n, lambda o: _lo5a_upd(o, n, ring),
                             _FS["i20"], _shrex_inv)
        lo_b, sl, shh = _LIFT[kind]
        return _inv_lift(arr, n, lo_b(n), _FS["i" + sl], _FS["i" + shh])

    iscale_l = _FS["i" + _LIFT[kind][1]] if kind in _LIFT else None
    if sh == 1:
        # column pass n==1: out[0] = iscaleL(in[0]) - stale >> 1
        st = (stale[..., :sw] >> 1) if stale is not None else 0
        c = (iscale_l(sub[..., 0, :]) - st)[..., None, :]
    else:
        c = run(sub.transpose(-1, -2), sh, axis=0).transpose(-1, -2)
    if sw == 1:
        # row pass n==1: the low-pass update reads the coefficient
        # buffer's column 1 (still the untouched higher-frequency coef)
        nb = (x[..., :sh, 1] >> 1) if w > 1 else 0
        out = (iscale_l(c[..., :, 0]) - nb)[..., None]
    else:
        out = run(c, sw, axis=1)
    x[..., :sh, :sw] = out


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def degenerate(cfg: SbtCfg):
    """True when some non-Haar level has a 1-px sub dimension, so the
    reference's scratch-row-1 / coef-column-1 reads become reachable
    (extreme aspect ratios; see _filter_2d_fwd). Such planes need the
    fwd carry threaded into the in-loop inverse."""
    for l in range(1, cfg.lvls + 1):
        if _kind(cfg, l) == "haar":
            continue
        if (im.round_shift(cfg.cw, l - 1) == 1
                or im.round_shift(cfg.ch, l - 1) == 1):
            return True
    return False


def _fwd_graph(cfg, x, blockdata):
    x = x.to(torch.int32, copy=True)
    carry = torch.zeros(x.shape[:-2] + (cfg.cw,), dtype=torch.int32,
                        device=x.device)
    for l in range(1, cfg.lvls + 1):
        kind = _kind(cfg, l)
        if kind == "haar":
            sw = im.round_shift(cfg.cw, l - 1)
            sh = im.round_shift(cfg.ch, l - 1)
            x[..., :sh, :sw] = _haar_fwd(x[..., :sh, :sw], sh, sw,
                                         _ovf(cfg, l))
        else:
            _filter_2d_fwd(x, cfg, l, kind, blockdata, carry)
    return x, carry


@functools.lru_cache(maxsize=None)
def make_fwd_sbt_carry(cfg: SbtCfg):
    """Returns fn(x int32[..., ch, cw], blockdata uint8[..., nbv, nbh]) ->
    (coefs int32[..., ch, cw], carry int32[..., cw]): the transform plus
    the scratch-row-1 carry the in-loop inverse of a degenerate plane must
    consume. Leading dims (frames) are independent."""
    if cfg.isP:
        raise NotImplementedError("P-frame transform: ROADMAP item 14")

    def fwd(x, blockdata):
        if x.dtype != torch.int32 or blockdata.dtype != torch.uint8:
            raise TypeError("x must be int32 and blockdata uint8, got "
                            "%s, %s" % (x.dtype, blockdata.dtype))
        if tuple(x.shape[-2:]) != (cfg.ch, cfg.cw):
            raise ValueError("plane shape %s != %s"
                             % (tuple(x.shape), (cfg.ch, cfg.cw)))
        return _fwd_graph(cfg, x, blockdata)

    return fwd


def _inv_graph(cfg, x, blockdata, q, stale):
    """q: int32 (..., 1, 1), one quantizer per frame."""
    x = x.to(torch.int32, copy=True)
    for l in range(cfg.lvls, 0, -1):
        kind = _kind(cfg, l)
        ovf = _ovf(cfg, l)
        if kind != "haar":
            _filter_2d_inv(x, cfg, l, kind, blockdata, stale)
            continue
        sw = im.round_shift(cfg.cw, l - 1)
        sh = im.round_shift(cfg.ch, l - 1)
        if cfg.lossless or (not cfg.is_luma and cfg.isP):
            out = _haar_inv_simple(x[..., :sh, :sw], sh, sw, ovf)
        else:
            if cfg.is_luma:
                div = 14 if cfg.isP else (2 if l > 4 else 8)
            else:
                div = 2
            hqp = torch.div(q, div, rounding_mode="floor")
            out = _haar_inv_filtered(x, sh, sw, ovf, hqp)
        x[..., :sh, :sw] = out
    return x


def _check_inv(cfg, x, blockdata, q):
    if (x.dtype != torch.int32 or blockdata.dtype != torch.uint8
            or q.dtype != torch.int32):
        raise TypeError("coefs/q must be int32 and blockdata uint8, got "
                        "%s, %s, %s" % (x.dtype, blockdata.dtype, q.dtype))
    if tuple(x.shape[-2:]) != (cfg.ch, cfg.cw):
        raise ValueError("plane shape %s != %s"
                         % (tuple(x.shape), (cfg.ch, cfg.cw)))


@functools.lru_cache(maxsize=None)
def make_inv_sbt(cfg: SbtCfg):
    """Returns fn(coefs int32[..., ch, cw], blockdata uint8[..., nbv, nbh],
    q int32[...]) -> pixel-domain int32[..., ch, cw] (still centered; add
    128 and clamp separately). For degenerate planes this assumes a zero
    scratch row — encoder in-loop callers use make_inv_sbt_stale."""
    def inv(x, blockdata, q):
        _check_inv(cfg, x, blockdata, q)
        return _inv_graph(cfg, x, blockdata, q[..., None, None], None)

    return inv


@functools.lru_cache(maxsize=None)
def make_inv_sbt_stale(cfg: SbtCfg):
    """Inverse taking the scratch-row-1 state int32[..., cw] — the fwd
    carry for the encoder's in-loop inverse."""
    def inv(x, blockdata, q, stale):
        _check_inv(cfg, x, blockdata, q)
        return _inv_graph(cfg, x, blockdata, q[..., None, None], stale)

    return inv
