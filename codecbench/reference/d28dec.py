"""Self-contained DSV2 v2.8 conformance decoder (numpy only).

An independent second implementation of the full decode path — bitstream,
entropy scan, adaptive dequantization, inverse subband transform, motion
compensation and the in-loop filters — sharing no code with the codec
under test (ref: single-header-decoder/dsv28dec.h:264-336 for the API
role; normative behavior per src/{bs,hzcc,sbt,bmc,dsv_decoder}.c).

A frozen copy of the repository's conformance decoder, the benchmark's
plain reference. One addition, which changes no decoded pixel:
`ConformanceDecoder.plane_faults` counts the planes whose payload fails
its guards or whose parse does not end exactly at the plane's length
(the stock decoder only resyncs there).

Everything here is plain numpy + python; decode speed is secondary to
independence and byte-exactness.
"""
import struct

import numpy as np

# ---------------------------------------------------------------------------
# format constants (wire-frozen; ref: src/dsv.h)
# ---------------------------------------------------------------------------

FOURCC = b"DSV2"
PT_META, PT_PIC, PT_EOS = 0x00, 0x04, 0x10
HDR_SIZE = 14
NEXT_OFF = 10
B = 32                      # frame border (ref: dsv_internal.h:38)
MAX_QP_BITS = 12

SUB_MODE, SUB_MV_X, SUB_MV_Y, SUB_SBIM, SUB_EPRM, SUB_NSUB = range(6)
STABLE_STAT, MAINTAIN_STAT, RINGING_STAT, MODE_STAT, EPRM_STAT = range(5)
ONE_MARKER, ZERO_MARKER = 0, 1

MV_INTRA, MV_EPRM, MV_MAINTAIN, MV_SKIP = 1, 2, 4, 8
MASK_ALL_INTRA = 0xF
SRC_DC_PRED = 0x100

IS_STABLE, IS_MAINTAIN, IS_SKIP, IS_RINGING = 1, 2, 4, 8
IS_INTRA, IS_EPRM, IS_SIMCMPLX = 16, 32, 64
NDIF_THRESH = 8
BIP = 14                    # block-grid fixed point (DSV_BLOCK_INTERP_P)

MAXLVL = 3
MINQUANT = 8
LVL1, LVL2, LVL3 = 2, 1, 0
LH, HL, HH = 1, 2, 3
EOP_SYMBOL = 0x55


def _hsh(subsamp):
    return (subsamp >> 2) & 0x3


def _vsh(subsamp):
    return subsamp & 0x3


# ---------------------------------------------------------------------------
# integer helpers (C semantics)
# ---------------------------------------------------------------------------

def divt(a, b):
    """C truncating integer division."""
    q = np.floor_divide(a, b)
    r = a - q * b
    adj = (r != 0) & ((np.sign(a) < 0) != (np.sign(b) < 0))
    return q + adj


def rshift(x, s):
    """round-to-up shift used for plane dims: ceil(x / 2**s)."""
    return -(-x // (1 << s))


def rpow2(x, p):
    m = (1 << p) - 1
    return (x + m) & ~m


def lb2(n):
    """Smallest s with (1 << s) >= n (ref: dsv.c:449-459)."""
    n = int(n)
    i, s = 1, 0
    while i < n:
        i <<= 1
        s += 1
    return s


def nlevels(w, h):
    """(ref: sbt.c:833-845)."""
    mx = max(w, h)
    l = lb2(mx)
    if mx > (1 << l):
        l += 1
    return l


# ---------------------------------------------------------------------------
# bit reading (MSB first; ref: src/bs.c)
# ---------------------------------------------------------------------------

class CorruptStream(Exception):
    """A read ran away past the packet end. The reference has no reader
    guard (dsv28dec.h:864-868 reads whatever heap bytes follow the packet);
    the twin reads a deterministic zero tail instead and bails after a
    bounded overrun so corrupt exp-Golomb runs cannot loop forever. Plane
    errors are caught per-plane (mirroring dsv28dec.h:3118-3152); anything
    else is caught at the packet level and decode continues."""


class Bits:
    def __init__(self, buf, bitpos=0):
        self.buf = buf
        self.pos = bitpos
        self.nbits = len(buf) << 3
        self.overrun = 0

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def bytepos(self):
        return self.pos >> 3

    def bit(self):
        if self.pos >= self.nbits:
            # zero tail past the packet (deterministic stand-in for the
            # reference's undefined out-of-bounds heap read)
            self.pos += 1
            self.overrun += 1
            if self.overrun > (1 << 16):
                raise CorruptStream("read past packet end")
            return 0
        v = (self.buf[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return v

    def bits(self, n):
        out = 0
        for _ in range(n):
            out = (out << 1) | self.bit()
        return out

    def ueg(self):
        v = 1
        while not self.bit():
            v = (v << 1) | self.bit()
        return v - 1

    def seg(self):
        v = self.ueg()
        if v and self.bit():
            return -v
        return v

    def neg(self):
        v = self.ueg() + 1
        if v and self.bit():
            return -v
        return v

    def rice(self, rk, damp):
        k = rk >> damp
        q = 0
        while not self.bit():
            q += 1
        if q:
            rk += 1
        elif rk > 0:
            rk -= 1
        return (q << k) | (self.bits(k) if k else 0), rk

    def nrice(self, rk, damp):
        v, rk = self.rice(rk, damp)
        u = v + 1
        return (u >> 1) ^ -(u & 1), rk


class Zbrle:
    """Zero-bit RLE reader (ref: bs.c:284-330)."""

    def __init__(self, buf, bitpos):
        self.bs = Bits(buf, bitpos)
        self.nz = 0

    def get(self):
        if self.nz == 0:
            self.nz = self.bs.ueg()
            return 1 if self.nz == 0 else 0
        self.nz -= 1
        return 1 if self.nz == 0 else 0


# ---------------------------------------------------------------------------
# plane geometry
# ---------------------------------------------------------------------------

def plane_dims(subsamp, w, h):
    cw = rshift(w, _hsh(subsamp))
    ch = rshift(h, _vsh(subsamp))
    return [(w, h), (cw, ch), (cw, ch)]


def coef_dims(subsamp, w, h):
    cw = rpow2(rshift(w, _hsh(subsamp)), 1)
    ch = rpow2(rshift(h, _vsh(subsamp)), 1)
    return [(w, h), (cw, ch), (cw, ch)]


# ---------------------------------------------------------------------------
# entropy scan (ref: hzcc.c:450-583 framing, bs.c code families)
# ---------------------------------------------------------------------------

def _dimat(l, v):
    return rshift(v, MAXLVL - l)


def _suboff(l, s, w, h):
    return (_dimat(l, h) if (s & 2) else 0), (_dimat(l, w) if (s & 1) else 0)


def subband_plan(w, h):
    plan = []
    for l in range(MAXLVL):
        sw, sh = _dimat(l, w), _dimat(l, h)
        for s in (1, 2, 3):
            r0, c0 = _suboff(l, s, w, h)
            plan.append((l, s, r0, c0, sw, sh))
    return plan


def scan_segments(w, h):
    segs = [(_dimat(0, w) * _dimat(0, h), -1)]
    for (l, s, r0, c0, sw, sh) in subband_plan(w, h):
        segs.append((sw * sh, 3 + l))
    return segs


def scan_decode(bs, segments):
    """Run-length + NEG/adaptive-Rice scan into a flat value array. The
    section starts with a 24-bit run count then aligns
    (ref: hzcc.c:234-246, 462-583)."""
    nruns = bs.bits(24)
    bs.align()
    total = sum(c for c, _ in segments)
    v = np.zeros(total, np.int32)
    pos = 0
    seg = 0
    seg_end = segments[0][0]
    damp = segments[0][1]
    vk = 0
    for _ in range(nruns):
        run = bs.ueg()
        pos += run
        if pos >= total:
            break
        while pos >= seg_end and seg + 1 < len(segments):
            seg += 1
            seg_end += segments[seg][0]
            damp = segments[seg][1]  # rice vk persists across segments
        if damp < 0:
            val = bs.neg()
        else:
            val, vk = bs.nrice(vk, damp)
        v[pos] = val
        pos += 1
    return v


# ---------------------------------------------------------------------------
# adaptive dequantization (ref: hzcc.c:65-228, 450-583)
# ---------------------------------------------------------------------------

def spatial_psy_factor(nbh, nbv, blk_w, blk_h, subband):
    if subband == LH:
        lo = -(-352 // blk_w)
        hi = -(-1920 // blk_w)
        scale = nbh
    elif subband == HL:
        lo = -(-288 // blk_h)
        hi = -(-1080 // blk_h)
        scale = nbv
    else:
        lo = -(-352 // blk_w) * -(-288 // blk_h)
        hi = -(-1920 // blk_w) * -(-1080 // blk_h)
        scale = nbh * nbv
    return (max(0, scale - lo) << 7) // (hi - lo)


def lfquant(q, psyHH, is_luma):
    q = q - ((q * psyHH) >> 10)
    q = max(q, MINQUANT)
    if not is_luma:
        if q > 256:
            q = 256 + q // 4
        return min(q, 768)
    return min(q, 3072)


def hfquant(q, s, l, is_luma, isP, subsamp, psy_s):
    q = q // 2
    psyfac = (q * psy_s) >> (7 + (0 if isP else 1))
    if not is_luma:
        tl = l - 2
        if s == LH:
            tl += _hsh(subsamp)
        elif s == HL:
            tl += _vsh(subsamp)
        q = int(divt(q * 6, 4 - tl))
    else:
        if l == LVL2:
            q = q + int(divt(psyfac, 2))
        elif l == LVL1:
            q = q + psyfac
    if isP:
        if l != LVL1:
            if l == LVL3:
                q = q * 2 - psyfac
            else:
                q = q - int(divt(psyfac, 2))
        return max(int(divt(q, 4)), MINQUANT)
    q = int(divt(q * (15 + 3 * l), 16))
    if is_luma:
        if l == LVL3:
            q = int(divt(q * 3, 8))
        elif s == HH:
            q = q * 2
    else:
        q = int(divt(q, 4))
        if s == HH:
            q = q * 2
    return max(q, MINQUANT)


def dequant_s(v, q):
    return v * q + np.where(v < 0, -divt(q * 2, 3), divt(q * 2, 3))


def dequant_d(v, q):
    return v * q + np.where(v < 0, -(q // 2), q // 2)


def tmq4pos_p(tmq, flags, parc):
    c1 = (parc != 0) | ((flags & (IS_STABLE | IS_EPRM)) != 0)
    c2 = (parc == 0) & ((flags & IS_INTRA) != 0)
    return np.where(c1, (tmq * 7) >> 3, np.where(c2, (tmq * 6) >> 3, tmq))


def tmq4pos_i(tmq, flags, parc, l):
    if l == MAXLVL - 3:
        return np.broadcast_to(np.asarray(tmq), flags.shape)
    smf = flags & (IS_STABLE | IS_MAINTAIN)
    ring = (flags & IS_RINGING) != 0
    notparc = (parc == 0).astype(np.int64)
    mshift = np.where(ring, 2, notparc)
    if l == MAXLVL - 2:
        t_stable = divt(tmq, 3)
        t_both = tmq >> 2
    else:
        t_stable = tmq >> 2
        t_both = tmq >> (2 + notparc)
    t_maint = tmq >> mshift
    return np.where(smf == IS_STABLE, t_stable,
                    np.where(smf == IS_MAINTAIN, t_maint,
                             np.where(smf == (IS_MAINTAIN | IS_STABLE),
                                      t_both, tmq)))


def _block_axes(sw, sh, nbh, nbv):
    dbx = (nbh << BIP) // sw
    dby = (nbv << BIP) // sh
    by = (np.arange(sh) * dby) >> BIP
    bx = (np.arange(sw) * dbx) >> BIP
    return by, bx


def dequantize(v_scan, blockdata, q, ll_value, w, h, is_luma, isP,
               lossless, nbh, nbv, blk_w, blk_h, subsamp):
    """Scan values -> dequantized coefficient plane (ref: hzcc.c:450-583).
    Overlapping subband cells at non-multiple-of-16 dims resolve in scan
    order, including the serial in-band parent rereads."""
    q = (q * 3) // 2
    x = np.zeros((h, w), np.int64)
    sw0, sh0 = _dimat(0, w), _dimat(0, h)
    pos = sw0 * sh0
    v = v_scan[:pos].reshape(sh0, sw0).astype(np.int64)
    if lossless:
        x[:sh0, :sw0] = v
    else:
        psyHH = spatial_psy_factor(nbh, nbv, blk_w, blk_h, HH)
        qp = lfquant(q, psyHH, is_luma)
        deq = dequant_d(v, qp) if isP else dequant_s(v, qp)
        x[:sh0, :sw0] = np.where(v != 0, deq, 0)
    bd = blockdata.reshape(nbv, nbh).astype(np.int64)
    for (l, s, r0, c0, sw, sh) in subband_plan(w, h):
        v = v_scan[pos:pos + sw * sh].reshape(sh, sw).astype(np.int64)
        pos += sw * sh
        if lossless:
            cur = x[r0:r0 + sh, c0:c0 + sw]
            x[r0:r0 + sh, c0:c0 + sw] = np.where(v != 0, v, cur)
            continue
        psy_s = spatial_psy_factor(nbh, nbv, blk_w, blk_h, s)
        qp = hfquant(q, s, l, is_luma, isP, subsamp, psy_s)
        by, bx = _block_axes(sw, sh, nbh, nbv)
        flags = bd[by[:, None], bx[None, :]]
        pr0, pc0 = _suboff(l - 1, s, w, h)
        pys = pr0 + (np.arange(sh) >> 1)
        pxs = pc0 + (np.arange(sw) >> 1)

        # serial scan: a cell's parent may live in this same (overlapping)
        # subband region — including the just-written neighbor in the same
        # row, or the cell ITSELF at saturated degenerate dims (then the
        # reference reads the pre-write slot). Cell-by-cell replicates the
        # reference's raster scan exactly; the overlap regions are tiny.
        overlap = (((pys >= r0) & (pys < r0 + sh)).any()
                   and ((pxs >= c0) & (pxs < c0 + sw)).any())
        if not overlap:
            parc = x[pys[:, None], pxs[None, :]]
            tmq = (tmq4pos_p(qp, flags, parc) if isP
                   else tmq4pos_i(qp, flags, parc, l))
            cur = x[r0:r0 + sh, c0:c0 + sw]
            x[r0:r0 + sh, c0:c0 + sw] = np.where(
                v != 0, dequant_d(v, tmq), cur)
        else:
            for y in range(sh):
                for cx in range(sw):
                    if v[y, cx] == 0:
                        continue
                    parc = x[pys[y], pxs[cx]]
                    tmq = (tmq4pos_p(qp, flags[y, cx], parc) if isP
                           else tmq4pos_i(qp, flags[y, cx], parc, l))
                    x[r0 + y, c0 + cx] = dequant_d(v[y, cx], tmq)
    x[0, 0] = ll_value
    return x


# ---------------------------------------------------------------------------
# inverse subband transform (ref: src/sbt.c)
# ---------------------------------------------------------------------------

CC0, CCS = 3, 4
CCA = 1 << (CCS - 1)
R20, R2S = 3, 3
R2A = 1 << (R2S - 1)
S20, S2S = 9, 5
S2A = 1 << (S2S - 1)
SHREX2 = 3


def _reflect(i, n):
    i = np.abs(np.asarray(i))
    return np.where(i >= n, n + n - i, i)


def _hi3_upd(e, n):
    if n % 2:
        return (e[..., :-1] + e[..., 1:] + 1) >> 1
    if n == 2:
        return e[..., -1:]
    std = (e[..., :-1] + e[..., 1:] + 1) >> 1
    return np.concatenate([std, e[..., -1:]], axis=-1)


def _lo3_upd(o, n):
    ne, no = n - n // 2, n // 2
    parts = [o[..., :1] >> 1]
    if no > 1:
        parts.append((o[..., :-1] + o[..., 1:] + 2) >> 2)
    if ne > no:
        parts.append(np.zeros(o.shape[:-1] + (1,), o.dtype))
    return np.concatenate(parts, axis=-1)


def _lo5_mid(o, n, c0, ca, cs):
    no = n // 2
    k = np.arange(1, no)
    il = (_reflect(2 * k - 3, n - 1) - 1) // 2
    ir = (_reflect(2 * k + 3, n - 1) - 1) // 2
    return (-o[..., il] + c0 * (o[..., 0:no - 1] + o[..., 1:no])
            - o[..., ir] + ca) >> cs


def _lo5_upd(o, n, c0, ca, cs):
    ne, no = n - n // 2, n // 2
    parts = [o[..., :1] >> 1]
    if no > 1:
        parts.append(_lo5_mid(o, n, c0, ca, cs))
    if ne > no:
        parts.append(np.zeros(o.shape[:-1] + (1,), o.dtype))
    return np.concatenate(parts, axis=-1)


def _lo5a_upd(o, n, ring):
    ne, no = n - n // 2, n // 2
    parts = [o[..., :1] >> 1]
    if no > 1:
        std = _lo5_mid(o, n, S20, S2A, S2S)
        rng = _lo5_mid(o, n, R20, R2A, R2S)
        parts.append(np.where(ring, rng, std))
    if ne > no:
        parts.append(np.zeros(o.shape[:-1] + (1,), o.dtype))
    return np.concatenate(parts, axis=-1)


def _interleave(e, o, n):
    out = np.zeros(e.shape[:-1] + (n,), e.dtype)
    out[..., 0::2] = e
    out[..., 1::2] = o
    return out


def _shrex_inv(x):
    th = divt(x, 3)
    return th + (th >> SHREX2)


_ISCALE = {
    "i52": lambda x: divt(x * 2, 5), "i20": lambda x: divt(x, 2),
    "i40": lambda x: divt(x, 4), "ino": lambda x: x,
}


def _inv_lift(x, n, lo_fn, iscale_l, iscale_h):
    ne = n - n // 2
    e = iscale_l(x[..., :ne])
    o = iscale_h(x[..., ne:])
    e = e - lo_fn(o)
    o = o + _hi3_upd(e, n)
    return _interleave(e, o, n)


def _haar_quads(sub, hs, ws, ovf):
    he, we = hs // 2, ws // 2
    hc, wc = hs - he, ws - we
    ll = sub[:hc, :wc] * (1 << ovf)
    return ll, sub[:hc, wc:], sub[hc:, :wc], sub[hc:, wc:], he, we, hc, wc


def _haar_recombine(ll, lh, hl, hh, hs, ws, he, we, hc, wc):
    if wc > we:
        lh = np.concatenate([lh, np.zeros((lh.shape[0], 1), lh.dtype)], 1)
        hh = np.concatenate([hh, np.zeros((hh.shape[0], 1), hh.dtype)], 1)
    if hc > he:
        hl = np.concatenate([hl, np.zeros((1, wc), hl.dtype)], 0)
        hh = np.concatenate([hh, np.zeros((1, wc), hh.dtype)], 0)
    a = divt(ll + lh + hl + hh, 4)
    b = divt(ll - lh + hl - hh, 4)[:, :we]
    c = divt(ll + lh - hl - hh, 4)[:he, :]
    d = divt(ll - lh - hl + hh, 4)[:he, :we]
    out = np.zeros((hs, ws), ll.dtype)
    out[0::2, 0::2] = a
    out[0::2, 1::2] = b
    out[1::2, 0::2] = c
    out[1::2, 1::2] = d
    return out


def _round2(v):
    return divt(v + np.where(v < 0, -1, 1), 2)


def _round4(v):
    return divt(v + np.where(v < 0, -2, 2), 4)


def _nudge(center, lp, ln, hf, hqp):
    mx = center - ln
    mn = lp - center
    lo = np.minimum(np.maximum(mn, mx), 0)
    hi = np.maximum(np.minimum(mn, mx), 0)
    t = _round4(lp - ln)
    nud = _round2(np.clip(t, lo, hi) - hf * 2)
    upd = hf + np.clip(nud, -hqp, hqp)
    return np.where(lo != hi, upd, hf)


def _haar_inv_filtered(x, hs, ws, ovf, hqp):
    sub = x[:hs, :ws]
    ll, lh, hl, hh, he, we, hc, wc = _haar_quads(sub, hs, ws, ovf)
    if we > 0 and he > 0:
        llm = ll[:he, :we]
        lp = sub[:he, 0:we - 1] * (1 << ovf)
        ln = sub[:he, 2:we + 1] * (1 << ovf)
        lh = lh.copy()
        lh[:he, 1:we] = _nudge(llm[:, 1:], lp, ln, lh[:he, 1:we], hqp)
        if he > 1:
            lpv = sub[0:he - 1, :we] * (1 << ovf)
            lnv = sub[2:he + 1, :we] * (1 << ovf)
            hl = hl.copy()
            hl[1:he, :we] = _nudge(llm[1:, :], lpv, lnv, hl[1:he, :we], hqp)
    return _haar_recombine(ll, lh, hl, hh, hs, ws, he, we, hc, wc)


def _kind(is_luma, isP, lossless, lvls, l):
    if lossless:
        return "lossless" if 1 <= l <= lvls - 2 else "haar"
    if is_luma and not isP and l == 4:
        return "lli"
    if is_luma and isP and l == 4:
        return "llp"
    if not is_luma and not isP and 1 <= l <= lvls - 2:
        return "cc"
    if is_luma and not isP and l == 2:
        return "l2a"
    if is_luma and not isP and l == 1:
        return "l1"
    return "haar"


def _ring_line(nb_perp, nb_along, s_perp, s_along):
    d_perp = (nb_perp << BIP) // s_perp
    d_along = (nb_along << BIP) // s_along
    rows = (np.arange(s_perp) * d_perp) >> BIP
    npos = max(s_along // 2 - 1, 0)
    cols = (np.arange(npos) * 2 * d_along) >> BIP
    return rows, cols


def inv_sbt(x, blockdata, q, cw, ch, is_luma, isP, lossless, nbh, nbv,
            arena=None):
    """Synthesis filter bank (ref: sbt.c:833-885 + per-filter sections).

    `arena` (1-D int64, persistent per decode session) emulates the
    reference's shared scratch buffer (temp_buf_pad layout): degenerate
    1-px sub-dimension levels — reachable at extreme aspect ratios —
    read the stale scratch row 1 at flat[2*cw + i] that the previous
    plane/frame left behind, and every plane leaves its level-1 scratch
    rows in it (ref: sbt.c:199-225 DO_*_LO at n==1, :449-473)."""
    x = x.astype(np.int64)
    lvls = nlevels(cw, ch)
    bd = blockdata.reshape(nbv, nbh)
    tmp_l1 = None
    for l in range(lvls, 0, -1):
        kind = _kind(is_luma, isP, lossless, lvls, l)
        ovf = int(l >= 6 and l >= lvls - 3 and not lossless)
        sw, sh = rshift(cw, l - 1), rshift(ch, l - 1)
        if kind == "haar":
            if lossless or (not is_luma and isP):
                sub = x[:sh, :sw]
                ll, lh, hl, hh, he, we, hc, wc = _haar_quads(
                    sub, sh, sw, ovf)
                out = _haar_recombine(ll, lh, hl, hh, sh, sw,
                                      he, we, hc, wc)
            else:
                if is_luma:
                    hqp = q // (14 if isP else (2 if l > 4 else 8))
                else:
                    hqp = q // 2
                out = _haar_inv_filtered(x, sh, sw, ovf, hqp)
            x[:sh, :sw] = out
            if l == 1:
                tmp_l1 = out
            continue

        def run(arr, n, axis):
            if kind == "l1":
                return _inv_lift(arr, n, lambda o: _lo3_upd(o, n),
                                 _ISCALE["i20"], _ISCALE["i40"])
            if kind == "l2a":
                if axis == 1:
                    rows, cols = _ring_line(nbv, nbh, sh, sw)
                    ring = bd[rows[:, None], cols[None, :]]
                else:
                    rows, cols = _ring_line(nbh, nbv, sw, sh)
                    ring = bd[cols[None, :], rows[:, None]]
                ring = (ring & IS_RINGING) != 0
                return _inv_lift(arr, n, lambda o: _lo5a_upd(o, n, ring),
                                 _ISCALE["i20"], _shrex_inv)
            if kind == "cc":
                return _inv_lift(arr, n,
                                 lambda o: _lo5_upd(o, n, CC0, CCA, CCS),
                                 _ISCALE["i20"], _ISCALE["ino"])
            if kind == "lli":
                return _inv_lift(arr, n, lambda o: _lo3_upd(o, n),
                                 _ISCALE["i52"], _ISCALE["i40"])
            if kind == "llp":
                return _inv_lift(arr, n, lambda o: _lo3_upd(o, n),
                                 _ISCALE["i52"], _ISCALE["i20"])
            # lossless mid levels
            return _inv_lift(arr, n, lambda o: _lo3_upd(o, n),
                             _ISCALE["ino"], _ISCALE["ino"])

        iscl = {"cc": "i20", "l1": "i20", "l2a": "i20", "lli": "i52",
                "llp": "i52"}.get(kind, "ino")
        sub = x[:sh, :sw]
        if sh == 1:
            # column pass n==1: iscaleL then the lo update reads the
            # stale scratch row 1
            st = (arena[2 * cw:2 * cw + sw] if arena is not None
                  else np.int64(0))
            c = (_ISCALE[iscl](sub[0]) - (st >> 1))[None, :]
        else:
            c = run(sub.T, sh, axis=0).T
        if sw == 1:
            # row pass n==1: the lo update reads coef column 1
            nb = (x[:sh, 1] >> 1) if cw > 1 else np.int64(0)
            x[:sh, :sw] = (_ISCALE[iscl](c[:, 0]) - nb)[:, None]
        else:
            x[:sh, :sw] = run(c, sw, axis=1)
        if l == 1:
            tmp_l1 = c
    if arena is not None and tmp_l1 is not None:
        n = arena.shape[0]
        r = 0
        while cw * (1 + r) < n and r < tmp_l1.shape[0]:
            a = cw * (1 + r)
            ln = min(cw, n - a)
            arena[a:a + ln] = tmp_l1[r, :ln]
            r += 1
    return x


# ---------------------------------------------------------------------------
# motion compensation (ref: src/bmc.c:661-987)
# ---------------------------------------------------------------------------

def _hpf_a(a, b, c, d):
    return 19 * (b + c) - 3 * (a + d)


def _hpf_b(a, b, c, d):
    return 20 * (b + c) - 4 * (a + d)


def _qp_blend(f, b, c, phase):
    out = np.empty_like(f)
    for p, expr in enumerate([
            (64 * b + 32) >> 6, (f + 32 * b + 32) >> 6,
            (f * 2 + 32) >> 6, (f + 32 * c + 32) >> 6]):
        out = np.where(phase == p, expr, out)
    return out


def predict_plane(ref, mvx, mvy, flags, submask, dc, tmc,
                  w, h, bw, bh, nbh, nbv, sh_, sv_, is_luma):
    """Whole-plane prediction canvas (nbv*bh, nbh*bw) from the bordered
    reference plane (ref: bmc.c:661-923)."""
    gw, gh = nbh * bw, nbv * bh
    jj = np.repeat(np.arange(nbv), bh)
    ii = np.repeat(np.arange(nbh), bw)

    def bcast(m):
        return m[jj][:, ii]

    def gather(by, bx):
        by = np.clip(by, 0, ref.shape[0] - 1)
        bx = np.clip(bx, 0, ref.shape[1] - 1)
        return ref[by, bx].astype(np.int64)

    ibase = np.arange(nbh) * bw
    jbase = np.arange(nbv) * bh
    limx = w - bw + B - 1
    limy = h - bh + B - 1
    Y = np.arange(gh)[:, None]
    X = np.arange(gw)[None, :]
    pxb = ibase[None, :] + (mvx >> (2 + sh_))
    pyb = jbase[:, None] + (mvy >> (2 + sv_))
    wx = B + X + bcast(np.clip(pxb, -B, limx) - ibase[None, :])
    wy = B + Y + bcast(np.clip(pyb, -B, limy) - jbase[:, None])
    wholepel = gather(wy, wx)

    if is_luma:
        sx = B + X + bcast(np.clip(pxb - 1, -B, limx) - ibase[None, :])
        sy = B + Y + bcast(np.clip(pyb - 1, -B, limy) - jbase[:, None])
        large = (np.abs(mvx) >= 8) | (np.abs(mvy) >= 8)
        dxp = mvx & 3
        dyp = mvy & 3
        tmc_odd = (tmc & 1) != 0
        dqtx = bcast(large | ((dxp & 1) == 0) | tmc_odd)
        dqty = bcast(large | ((dyp & 1) == 0) | tmc_odd)
        dxp_p = bcast(dxp)
        dyp_p = bcast(dyp)
        rows = []
        for t in range(4):
            a = gather(sy + t, sx + 0)
            b_ = gather(sy + t, sx + 1)
            c_ = gather(sy + t, sx + 2)
            d_ = gather(sy + t, sx + 3)
            fv = np.where(dqtx, _hpf_a(a, b_, c_, d_),
                          _hpf_b(a, b_, c_, d_))
            rows.append(_qp_blend(fv, b_, c_, dxp_p))
        fv = np.where(dqty, _hpf_a(rows[0], rows[1], rows[2], rows[3]),
                      _hpf_b(rows[0], rows[1], rows[2], rows[3]))
        subpel = np.clip(_qp_blend(fv, rows[1], rows[2], dyp_p), 0, 255)
        inter = np.where(bcast(((mvx | mvy) & 3) != 0), subpel, wholepel)
    else:
        hbits, vbits = 2 + sh_, 2 + sv_
        hf, vf = 1 << hbits, 1 << vbits
        sf = hbits + vbits
        dxc = mvx & (hf - 1)
        dyc = mvy & (vf - 1)
        p01 = gather(wy, wx + 1)
        p10 = gather(wy + 1, wx)
        p11 = gather(wy + 1, wx + 1)
        inter = (bcast((hf - dxc) * (vf - dyc)) * wholepel
                 + bcast(dxc * (vf - dyc)) * p01
                 + bcast((hf - dxc) * dyc) * p10
                 + bcast(dxc * dyc) * p11 + (1 << (sf - 1))) >> sf

    # intra fills (ref: bmc.c:845-900)
    sbw, sbh = bw // 2, bh // 2
    cpy = np.clip(pyb, -B, limy)
    cpx = np.clip(pxb, -B, limx)
    full_avg = np.zeros((nbv, nbh), np.int64)
    q_avg = np.zeros((4, nbv, nbh), np.int64)
    intra_any = (flags & MV_INTRA) != 0
    for j in range(nbv):
        for i in range(nbh):
            if not intra_any[j, i]:
                continue
            win = ref[cpy[j, i] + B:cpy[j, i] + B + bh,
                      cpx[j, i] + B:cpx[j, i] + B + bw].astype(np.int64)
            full_avg[j, i] = win.sum() // (bw * bh)
            k = 0
            for g in (0, sbh):
                for fx in (0, sbw):
                    q_avg[k, j, i] = (win[g:g + sbh, fx:fx + sbw].sum()
                                      // (sbw * sbh))
                    k += 1
    has_dc = (dc != 0) if is_luma else np.zeros_like(dc, bool)
    dc_val = dc & 0xFF
    fill_all = np.where(has_dc, dc_val, full_avg)
    fill_q = np.where(has_dc[None], dc_val[None], q_avg)
    ly = (np.arange(gh) % bh)
    lx = (np.arange(gw) % bw)
    qidx = ((ly >= sbh).astype(np.int64)[:, None] * 2
            + (lx >= sbw).astype(np.int64)[None, :])
    per_pix = fill_q[:, jj][:, :, ii]
    fill_q_pix = np.take_along_axis(per_pix, qidx[None], axis=0)[0]
    qbit = np.left_shift(1, qidx)
    qmask_pix = (bcast(submask) & qbit) != 0
    all_intra = bcast(submask == MASK_ALL_INTRA)
    intra_pix = np.where(all_intra, bcast(fill_all),
                         np.where(qmask_pix, fill_q_pix, wholepel))
    out = np.where(bcast(intra_any), intra_pix, inter)
    return out


def reconstruct(res, pred, flags, bw, bh, lossless):
    """(ref: bmc.c:925-987)."""
    nbv, nbh = flags.shape
    jj = np.repeat(np.arange(nbv), bh)[:res.shape[0]]
    ii = np.repeat(np.arange(nbh), bw)[:res.shape[1]]
    r = res.astype(np.int64)
    p = pred.astype(np.int64)
    if lossless:
        return ((p + r - 128) & 0xFF).astype(np.uint8)
    intra = (flags & MV_INTRA) != 0
    skip = (flags & MV_SKIP) != 0
    eprm = (flags & MV_EPRM) != 0
    use_eprm = (eprm & ~(~intra & skip))[jj][:, ii]
    normal = np.clip(p + r - 128, 0, 255)
    doubled = np.clip(p + (r - 128) * 2, 0, 255)
    return np.where(use_eprm, doubled, normal).astype(np.uint8)


# ---------------------------------------------------------------------------
# in-loop filters, raster-serial (ref: src/bmc.c:51-659)
# ---------------------------------------------------------------------------

def _lpf6(e0, i0, e1, i1):
    return (5 * (e0 + i0) + 3 * (e1 + i1) + 8) >> 4


def _flat6(e2, e1, e0, i0, i1, i2, avg, t):
    return ((np.abs(e0 - avg) < t) & (np.abs(i0 - avg) < t)
            & (np.abs(e1 - avg) < t) & (np.abs(i1 - avg) < t)
            & (np.abs(e2 - avg) < t) & (np.abs(i2 - avg) < t))


def _hfilt(p, x, y, edge, thE, thM, in_edge):
    """Vertical boundary at column x, rows y..y+3 (ref: bmc.c:51-119)."""
    if thM <= 0 or (edge and thE <= 0):
        return
    t = thE if edge else thM
    c = [p[y:y + 4, x + o].astype(np.int64) for o in range(-3, 8)]
    e2, e1, e0, i0, i1, i2 = c[0], c[1], c[2], c[3], c[4], c[5]
    avg = _lpf6(e0, i0, e1, i1)
    f = _flat6(e2, e1, e0, i0, i1, i2, avg, t)
    a5 = avg * 5
    p[y:y + 4, x - 2] = np.where(f, (3 * (avg + e1) + 2 * e2 + 4) >> 3, e1)
    p[y:y + 4, x - 1] = np.where(f, (a5 + 2 * e1 + e2 + 4) >> 3, e0)
    p[y:y + 4, x + 0] = np.where(f, avg, i0)
    p[y:y + 4, x + 1] = np.where(f, (a5 + 2 * i1 + i2 + 4) >> 3, i1)
    if not in_edge:
        return
    i2b, i1b, i0b, e0b, e1b, e2b = c[5], c[6], c[7], c[8], c[9], c[10]
    avgb = _lpf6(e0b, i0b, e1b, i1b)
    fb = _flat6(e2b, e1b, e0b, i0b, i1b, i2b, avgb, thM)
    a5b = avgb * 5
    p[y:y + 4, x + 3] = np.where(fb, (a5b + 2 * i1b + i2b + 4) >> 3, i1b)
    p[y:y + 4, x + 4] = np.where(fb, avgb, i0b)
    p[y:y + 4, x + 5] = np.where(fb, (a5b + 2 * e1b + e2b + 4) >> 3, e0b)
    p[y:y + 4, x + 6] = np.where(fb,
                                 (3 * (avgb + e1b) + 2 * e2b + 4) >> 3, e1b)


def _vfilt(p, x, y, edge, thE, thM, in_edge):
    """Horizontal boundary at row y, cols x..x+3 (ref: bmc.c:121-191)."""
    if thM <= 0 or (edge and thE <= 0):
        return
    t = thE if edge else thM
    r = [p[y + o, x:x + 4].astype(np.int64) for o in range(-3, 8)]
    e2, e1, e0, i0, i1, i2 = r[0], r[1], r[2], r[3], r[4], r[5]
    avg = _lpf6(e0, i0, e1, i1)
    f = _flat6(e2, e1, e0, i0, i1, i2, avg, t)
    a5 = avg * 5
    p[y - 2, x:x + 4] = np.where(f, (3 * (avg + e1) + 2 * e2 + 4) >> 3, e1)
    p[y - 1, x:x + 4] = np.where(f, (a5 + 2 * e1 + e2 + 4) >> 3, e0)
    p[y + 0, x:x + 4] = np.where(f, avg, i0)
    p[y + 1, x:x + 4] = np.where(f, (a5 + 2 * i1 + i2 + 4) >> 3, i1)
    if not in_edge:
        return
    i2b, i1b, i0b, e0b, e1b, e2b = r[5], r[6], r[7], r[8], r[9], r[10]
    avgb = _lpf6(e0b, i0b, e1b, i1b)
    fb = _flat6(e2b, e1b, e0b, i0b, i1b, i2b, avgb, thM)
    a5b = avgb * 5
    p[y + 3, x:x + 4] = np.where(fb, (a5b + 2 * i1b + i2b + 4) >> 3, i1b)
    p[y + 4, x:x + 4] = np.where(fb, avgb, i0b)
    p[y + 5, x:x + 4] = np.where(fb, (a5b + 2 * e1b + e2b + 4) >> 3, e0b)
    p[y + 6, x:x + 4] = np.where(fb,
                                 (3 * (avgb + e1b) + 2 * e2b + 4) >> 3, e1b)


def _quads4_v(t):
    """Per-lane 2x2 quadrant means of (L, 4, 4) tiles."""
    t = t.astype(np.int64)
    d0 = (t[:, 0, 0] + t[:, 0, 1] + t[:, 1, 0] + t[:, 1, 1] + 2) >> 2
    d1 = (t[:, 0, 2] + t[:, 0, 3] + t[:, 1, 2] + t[:, 1, 3] + 2) >> 2
    d2 = (t[:, 2, 0] + t[:, 2, 1] + t[:, 3, 0] + t[:, 3, 1] + 2) >> 2
    d3 = (t[:, 2, 2] + t[:, 2, 3] + t[:, 3, 2] + t[:, 3, 3] + 2) >> 2
    return d0, d1, d2, d3


def _tile_energy_v(t):
    """Per-lane tile texture energies of (L, 4, 4) tiles
    (ref: bmc.c:224-270)."""
    t = t.astype(np.int64)
    d0, d1, d2, d3 = _quads4_v(t)
    x0 = t[:, 0::2, 0::2]
    x1 = t[:, 0::2, 1::2]
    x2 = t[:, 1::2, 0::2]
    x3 = t[:, 1::2, 1::2]
    hh = np.abs(x0 - x1 - x2 + x3) >> 1
    sh = (np.abs(x0 - x1 + x2 - x3) + hh).sum(axis=(1, 2))
    sv = (np.abs(x0 + x1 - x2 - x3) + hh).sum(axis=(1, 2))
    hhl = np.abs(d0 - d1 - d2 + d3) >> 1
    slh = np.abs(d0 - d1 + d2 - d3) + hhl
    slv = np.abs(d0 + d1 - d2 - d3) + hhl
    return sh, sv, slh, slv


def _dsfactor_v(t):
    """Per-lane directional-structure factor (ref: bmc.c:193-222)."""
    d0, d1, d2, d3 = _quads4_v(t)
    sh = np.abs((d0 + d1) - (d3 + d2))
    sv = np.abs((d2 + d1) - (d3 + d0))
    d2b, d3b = 255 - d2, 255 - d3
    sh2 = np.abs(d0 - d1 + d2b - d3b)
    sv2 = np.abs(d0 + d1 - d2b - d3b) >> 2
    r = np.where(sh2 > sv2, (3 * sh2 + sv2 + 2) >> 2,
                 (3 * sv2 + sh2 + 2) >> 2)
    return np.where(np.maximum(sh, sv) < 8, 0, r)


def _curve_tex_v(tt):
    return np.where(tt < 8, (8 - tt) * 8, np.where(tt > 192, 0, tt - 7))


def _degrad_v(W, act):
    """Per-lane dynamic-range degradation of the 4x4 tile at window
    rows/cols 3..6, applied in place where act (ref: bmc.c:272-337)."""
    v = W[:, 3:7, 3:7].reshape(-1, 16).astype(np.int64)
    b = v >> 4
    onehot = b[:, None, :] == np.arange(16)[None, :, None]
    hist = onehot.sum(axis=2)
    sums = (onehot * v[:, None, :]).sum(axis=2)
    has = hist > 0
    lo = has.argmax(axis=1)
    hi = 15 - has[:, ::-1].argmax(axis=1)
    act = act & (lo < hi)
    take = lambda a, i: np.take_along_axis(a, i[:, None], 1)[:, 0]
    hl = np.maximum(take(hist, lo), 1)
    hh_ = np.maximum(take(hist, hi), 1)
    alo = np.maximum(take(sums, lo) // hl, 1)[:, None]
    ahi = np.maximum(take(sums, hi) // hh_, 1)[:, None]
    mid = (alo + ahi + 1) >> 1
    low = v + divt(hl[:, None] * (alo - v), 16)
    hig = v + divt(hh_[:, None] * (ahi - v), 16)
    nv = np.where(v < mid, low, np.where(v > mid, hig, v))
    out = np.where(act[:, None], nv, v)
    W[:, 3:7, 3:7] = out.reshape(-1, 4, 4)


def compute_filter_q(q, psyHH):
    """(ref: bmc.c:376-388)."""
    if q > 1536:
        q = 1536
    q += q * psyHH >> 10
    if q < 1024:
        q = 512 + q // 2
    return q


# --- lane-vectorized 4x4-tile filtering (anti-diagonal wavefront) ---
#
# The reference rasters 4x4 tiles and each tile's 6-tap windows overlap
# the writes of its left / up / up-right neighbors (bmc.c:51-659).  The
# raster result is reproduced exactly by processing anti-diagonals
# d = ti + 2*tj in order: every pixel a tile on diagonal d reads was
# last written on a diagonal < d, and same-diagonal tiles write
# pairwise-disjoint pixels — the same schedule the device wavefront
# implementation uses (ops/filters.py), re-derived here over numpy
# lanes.  Windows are (L, 11, 11) slabs centered so tile pixel (0, 0)
# sits at [3, 3]; updates scatter back as deltas (disjoint writes make
# addition exact).

def _diagonals(ntx, nty):
    for d in range(ntx + 2 * nty - 2):
        jlo = max(0, -(-(d - ntx + 1) // 2))
        jhi = min(nty - 1, d // 2)
        if jlo > jhi:
            continue
        tjs = np.arange(jlo, jhi + 1)
        yield (d - 2 * tjs)[::-1], tjs[::-1]


def _gather_win(c, xs, ys):
    oy = ys[:, None, None] + (8 - 3) + np.arange(11)[None, :, None]
    ox = xs[:, None, None] + (8 - 3) + np.arange(11)[None, None, :]
    return c[oy, ox]


def _scatter_win(c, xs, ys, W, W0):
    d = (W - W0)[:, 1:10, 1:10]       # write extent: rows/cols -2..+6
    oy = ys[:, None, None] + (8 - 2) + np.arange(9)[None, :, None]
    ox = xs[:, None, None] + (8 - 2) + np.arange(9)[None, None, :]
    np.add.at(c, (oy, ox), d)


def _hfilt_v(W, act, edge, thE, thM, in_edge):
    """Vertical boundary at window col 3, rows 3..6, per lane
    (ref: bmc.c:51-119)."""
    act = act & (thM > 0) & np.where(edge, thE > 0, True)
    t = np.where(edge, thE, thM)[:, None]
    c = [W[:, 3:7, k].astype(np.int64) for k in range(11)]
    e2, e1, e0, i0, i1, i2 = c[0], c[1], c[2], c[3], c[4], c[5]
    avg = _lpf6(e0, i0, e1, i1)
    f = _flat6(e2, e1, e0, i0, i1, i2, avg, t) & act[:, None]
    a5 = avg * 5
    W[:, 3:7, 1] = np.where(f, (3 * (avg + e1) + 2 * e2 + 4) >> 3, e1)
    W[:, 3:7, 2] = np.where(f, (a5 + 2 * e1 + e2 + 4) >> 3, e0)
    W[:, 3:7, 3] = np.where(f, avg, i0)
    W[:, 3:7, 4] = np.where(f, (a5 + 2 * i1 + i2 + 4) >> 3, i1)
    i2b, i1b, i0b, e0b, e1b, e2b = c[5], c[6], c[7], c[8], c[9], c[10]
    avgb = _lpf6(e0b, i0b, e1b, i1b)
    fb = _flat6(e2b, e1b, e0b, i0b, i1b, i2b, avgb, thM[:, None]) \
        & (act & in_edge)[:, None]
    a5b = avgb * 5
    W[:, 3:7, 6] = np.where(fb, (a5b + 2 * i1b + i2b + 4) >> 3, i1b)
    W[:, 3:7, 7] = np.where(fb, avgb, i0b)
    W[:, 3:7, 8] = np.where(fb, (a5b + 2 * e1b + e2b + 4) >> 3, e0b)
    W[:, 3:7, 9] = np.where(fb, (3 * (avgb + e1b) + 2 * e2b + 4) >> 3,
                            e1b)


def _vfilt_v(W, act, edge, thE, thM, in_edge):
    """Horizontal boundary at window row 3, cols 3..6, per lane
    (ref: bmc.c:121-191)."""
    act = act & (thM > 0) & np.where(edge, thE > 0, True)
    t = np.where(edge, thE, thM)[:, None]
    r = [W[:, k, 3:7].astype(np.int64) for k in range(11)]
    e2, e1, e0, i0, i1, i2 = r[0], r[1], r[2], r[3], r[4], r[5]
    avg = _lpf6(e0, i0, e1, i1)
    f = _flat6(e2, e1, e0, i0, i1, i2, avg, t) & act[:, None]
    a5 = avg * 5
    W[:, 1, 3:7] = np.where(f, (3 * (avg + e1) + 2 * e2 + 4) >> 3, e1)
    W[:, 2, 3:7] = np.where(f, (a5 + 2 * e1 + e2 + 4) >> 3, e0)
    W[:, 3, 3:7] = np.where(f, avg, i0)
    W[:, 4, 3:7] = np.where(f, (a5 + 2 * i1 + i2 + 4) >> 3, i1)
    i2b, i1b, i0b, e0b, e1b, e2b = r[5], r[6], r[7], r[8], r[9], r[10]
    avgb = _lpf6(e0b, i0b, e1b, i1b)
    fb = _flat6(e2b, e1b, e0b, i0b, i1b, i2b, avgb, thM[:, None]) \
        & (act & in_edge)[:, None]
    a5b = avgb * 5
    W[:, 6, 3:7] = np.where(fb, (a5b + 2 * i1b + i2b + 4) >> 3, i1b)
    W[:, 7, 3:7] = np.where(fb, avgb, i0b)
    W[:, 8, 3:7] = np.where(fb, (a5b + 2 * e1b + e2b + 4) >> 3, e0b)
    W[:, 9, 3:7] = np.where(fb, (3 * (avgb + e1b) + 2 * e2b + 4) >> 3,
                            e1b)


def _padded(fn):
    """Run a raster filter on an 8-px zero-padded canvas: tile windows
    read up to 7 px past the plane edge (the guarded second-boundary
    taps); the pad matches the wavefront layout's zero margins."""
    def wrap(p, pw, ph, *args, **kw):
        c = np.zeros((ph + 16, pw + 16), np.int64)
        c[8:8 + ph, 8:8 + pw] = p
        fn(c[8:, 8:], pw, ph, *args, **kw)
        p[:, :] = c[8:8 + ph, 8:8 + pw]
    return wrap


def intra_filter(p, pw, ph, blockdata, nbh, nbv, fq, fthresh):
    """Intra dering over 4x4 tiles, wavefront-vectorized
    (ref: bmc.c:390-457)."""
    nsbx, nsby = pw // 4, ph // 4
    ntx = max(0, (pw - 1) // 4)
    nty = max(0, (ph - 1) // 4)
    if ntx == 0 or nty == 0:
        return
    bd = blockdata.reshape(nbv, nbh)
    fx = (np.arange(ntx) * nbh) // max(nsbx, 1)
    fy = (np.arange(nty) * nbv) // max(nsby, 1)
    c = np.zeros((ph + 16, pw + 16), np.int64)
    c[8:8 + ph, 8:8 + pw] = p
    for tis, tjs in _diagonals(ntx, nty):
        xs, ys = tis * 4, tjs * 4
        flags = bd[fy[tjs], fx[tis]]
        act = (flags & IS_RINGING) == 0
        W0 = _gather_win(c, xs, ys)
        W = W0.copy()
        sh, sv, _, _ = _tile_energy_v(W[:, 3:7, 3:7])
        mx = np.maximum(sh, sv)
        act = act & (mx > 8) & (mx < 256)
        ds = _dsfactor_v(W[:, 3:7, 3:7])
        ds = np.where((flags & IS_STABLE) != 0, (ds * 5) >> 2, ds)
        tt = np.where((flags & (IS_MAINTAIN | IS_STABLE)) != 0, ds, 8)
        tt = np.clip((divt(tt * 2, 3) * fq) >> 12, 0, fthresh)
        acth = act & (tis >= 1)
        actv = act & (tjs >= 1)
        ieh = xs < pw - 8
        iev = ys < ph - 8
        edge = np.zeros(len(tis), bool)
        _hfilt_v(W, acth, edge, tt, tt, ieh)
        _vfilt_v(W, actv, edge, tt, tt, iev)
        tt2 = np.where(sh > sv, 3 * sh + sv, 3 * sv + sh)
        tt2 = 16 + ((_curve_tex_v(tt2) + 2) >> 2)
        tt2 = np.clip((tt2 * fq) >> 12, 0, fthresh)
        _hfilt_v(W, acth, edge, tt2, tt2, ieh)
        _vfilt_v(W, actv, edge, tt2, tt2, iev)
        _scatter_win(c, xs, ys, W, W0)
    p[:, :] = c[8:8 + ph, 8:8 + pw]


def _neighbordif2(mvx, mvy, flags, i, j):
    """(ref: dsv.c:402-438)."""
    cx, cy = int(mvx[j, i]), int(mvy[j, i])
    if abs(cx) < 2 and abs(cy) < 2:
        return 0, 0
    vx0, vy0 = cx, cy
    vx1, vy1 = cx, cy
    if i > 0 and (mvx[j, i - 1] or mvy[j, i - 1]) \
            and not (flags[j, i - 1] & MV_SKIP):
        vx0, vy0 = int(mvx[j, i - 1]), int(mvy[j, i - 1])
    if j > 0 and (mvx[j - 1, i] or mvy[j - 1, i]) \
            and not (flags[j - 1, i] & MV_SKIP):
        vx1, vy1 = int(mvx[j - 1, i]), int(mvy[j - 1, i])
    return abs(vx0 - cx) + abs(vy0 - cy), abs(vx1 - cx) + abs(vy1 - cy)


def _neighbordif2_grid(mvx, mvy, flags):
    """Whole-grid (left, top) neighbor MV differences (ref:
    dsv.c:402-438)."""
    cx = mvx.astype(np.int64)
    cy = mvy.astype(np.int64)
    small = (np.abs(cx) < 2) & (np.abs(cy) < 2)
    live = ((mvx != 0) | (mvy != 0)) & ((flags & MV_SKIP) == 0)
    lval = np.zeros_like(small)
    lval[:, 1:] = live[:, :-1]
    vx0 = np.where(lval, np.roll(cx, 1, axis=1), cx)
    vy0 = np.where(lval, np.roll(cy, 1, axis=1), cy)
    tval = np.zeros_like(small)
    tval[1:, :] = live[:-1, :]
    vx1 = np.where(tval, np.roll(cx, 1, axis=0), cx)
    vy1 = np.where(tval, np.roll(cy, 1, axis=0), cy)
    ndx = np.where(small, 0, np.abs(vx0 - cx) + np.abs(vy0 - cy))
    ndy = np.where(small, 0, np.abs(vx1 - cx) + np.abs(vy1 - cy))
    return ndx, ndy


def luma_filter(p, pw, ph, mvx, mvy, flags, submask, nbh, nbv,
                blk_w, blk_h, fq, fthresh, do_filter, tmc, inter_sharpen):
    """Inter luma cleanup over 4x4 tiles, wavefront-vectorized
    (ref: bmc.c:459-602)."""
    nsbx, nsby = pw // 4, ph // 4
    ntx = max(0, (pw - 1) // 4)
    nty = max(0, (ph - 1) // 4)
    if ntx == 0 or nty == 0:
        return
    fx = (np.arange(ntx) * nbh) // max(nsbx, 1)
    fy = (np.arange(nty) * nbv) // max(nsby, 1)
    thH = min(max((64 * fq) >> 12, 2), 32)
    thL = min(max((32 * fq) >> 12, 2), 32)
    sharpen = bool(inter_sharpen) and bool(tmc & 1)
    NDX, NDY = _neighbordif2_grid(mvx, mvy, flags)
    c = np.zeros((ph + 16, pw + 16), np.int64)
    c[8:8 + ph, 8:8 + pw] = p
    for tis, tjs in _diagonals(ntx, nty):
        xs, ys = tis * 4, tjs * 4
        bi, bj = fx[tis], fy[tjs]
        fl = flags[bj, bi].astype(np.int64)
        act = (fl & MV_SKIP) == 0
        if not act.any():
            continue
        mh = tis >= 1
        mv_ = tjs >= 1
        ieh = xs < pw - 8
        iev = ys < ph - 8
        eh = (xs % blk_w) == 0
        ev = (ys % blk_h) == 0
        bmvx = mvx[bj, bi].astype(np.int64)
        bmvy = mvy[bj, bi].astype(np.int64)
        amx, amy = np.abs(bmvx), np.abs(bmvy)
        intra = (fl & MV_INTRA) != 0
        W0 = _gather_win(c, xs, ys)
        W = W0.copy()

        # intra boundary smoothing (teh/tev gates)
        subne = submask[bj, bi] != MASK_ALL_INTRA
        teh = eh | (subne & ((xs % (blk_w // 2)) == 0))
        tev = ev | (subne & ((ys % (blk_h // 2)) == 0))

        # inter cleanup thresholds from tile energy at visit time
        sh, sv, slh, slv = _tile_energy_v(W[:, 3:7, 3:7])
        ndx, ndy = NDX[bj, bi], NDY[bj, bi]
        tndc = (ndx + ndy + 1) >> 1
        cdir = (sh < 2 * sv) & (sv < 2 * sh)
        ndx_e = np.where(cdir & (ndx < amx), ndx >> 1, ndx)
        ndy_e = np.where(cdir & (ndy < amy), ndy >> 1, ndy)
        shl = np.where(slh > 128, 0, 128 - slh)
        svl = np.where(slv > 128, 0, 128 - slv)
        ix = np.minimum(amx, 32)
        iy = np.minimum(amy, 32)
        ttc = (((sh * (32 - iy) + shl * iy) + 16) >> 5) \
            + (((sv * (32 - ix) + svl * ix) + 16) >> 5)
        ttc = (ttc + 1) >> 1
        ttc = np.where((ndx_e < amy) & (ndy_e < amx), 0, ttc)
        tt = np.where(cdir, ttc, (sh + sv + 1) >> 1)
        tt = (tt * tndc + 4) >> 3
        tt = (np.minimum(tt, fthresh) * fq) >> 12
        addx = (np.minimum(ndy_e, fthresh) * fq) >> 12
        addy = (np.minimum(ndx_e, fthresh) * fq) >> 12
        bv = (sh > 2 * sv) | (amy > 2 * amx)
        bh_ = ((sv > 2 * sh) | (amx > 2 * amy)) & ~bv
        mboth = ~bv & ~bh_
        eprm = (fl & MV_EPRM) != 0
        inter_on = act & ~intra & bool(do_filter) \
            & ((ndx != 0) | (ndy != 0))

        acth = np.where(intra, act, inter_on & (bh_ | mboth)) & mh
        actv = np.where(intra, act, inter_on & (bv | mboth)) & mv_
        edgeh = np.where(intra, teh, eh | eprm)
        edgev = np.where(intra, tev, ev | eprm)
        thEh = np.where(intra, thH, tt + addx)
        thEv = np.where(intra, thH, tt + addy)
        thM = np.where(intra, thL, tt)
        _hfilt_v(W, acth, edgeh, thEh, thM, ieh)
        _vfilt_v(W, actv, edgev, thEv, thM, iev)

        if sharpen:
            dg = act & ~intra & ((bmvx & 3) != 0) & ((bmvy & 3) != 0) \
                & (((bmvx | bmvy) & 1) != 0) & (amx < 8) & (amy < 8)
            _degrad_v(W, dg)
        _scatter_win(c, xs, ys, W, W0)
    p[:, :] = c[8:8 + ph, 8:8 + pw]


@_padded
def chroma_filter(p, pw, ph, mvx, mvy, flags, nbh, nbv, bw, bh, q):
    """Inter chroma filter, block-granular (ref: bmc.c:604-659)."""
    if nbh <= 0 or nbv <= 0 or pw < 8 or ph < 8:
        return
    ith = min(max((64 * q) >> 12, 2), 32)
    for bj in range(nbv):
        for bi in range(nbh):
            fl = int(flags[bj, bi])
            if fl & MV_SKIP:
                continue
            x0, y0 = bi * bw, bj * bh
            if fl & MV_INTRA:
                tx = ty = ith
            else:
                ndx, ndy = _neighbordif2(mvx, mvy, flags, bi, bj)
                amx, amy = abs(int(mvx[bj, bi])), abs(int(mvy[bj, bi]))
                if ndx < amy and ndy < amx:
                    tx = ty = 0
                else:
                    tx = (min(ndy, 64) * q) >> 12
                    ty = (min(ndx, 64) * q) >> 12
            ieh = x0 < pw - 8
            iev = y0 < ph - 8
            if 4 <= x0 <= pw - 4:
                for z in range(0, bh, 4):
                    if y0 + z + 4 < ph:
                        _hfilt(p, x0, y0 + z, False, tx, tx, ieh)
            if 4 <= y0 <= ph - 4:
                for z in range(0, bw, 4):
                    if x0 + z + 4 < pw:
                        _vfilt(p, x0 + z, y0, False, ty, ty, iev)


# ---------------------------------------------------------------------------
# border extension (ref: src/frame.c:250-410)
# ---------------------------------------------------------------------------

def _strip(vals):
    v = vals.astype(np.int64)
    n = v.shape[0]
    ln = n & ~3
    main = (v[:ln].reshape(-1, 4).sum(axis=1) + 2) >> 2
    if n & 3:
        main = np.concatenate([main, [v[ln:].sum() // (n & 3)]])
    return main.astype(np.uint8)


def extend_border(arr, w, h):
    vis = arr[B:B + h, B:B + w]
    ls = _strip(vis[:, 0])
    rs = _strip(vis[:, w - 1])
    ts = _strip(vis[0, :])
    bs = _strip(vis[h - 1, :])
    def cval(strip, dim):
        # dim < 4: the reference reads the zero byte just before the strip
        # allocation (calloc'd header pad; ref: frame.c:377-380, dsv.c:49-64)
        i = (dim // 4) - 1
        return int(strip[i]) if i >= 0 else 0

    tl = (int(ts[0]) + int(ls[0]) + 1) >> 1
    tr = (cval(ts, w) + int(rs[0]) + 1) >> 1
    bl = (cval(ls, h) + int(bs[0]) + 1) >> 1
    br = (cval(bs, w) + cval(rs, h) + 1) >> 1
    ridx = np.arange(h) // 4
    arr[B:B + h, :B] = ls[ridx][:, None]
    arr[B:B + h, B + w:] = rs[ridx][:, None]
    cidx = np.arange(w) // 4
    arr[:B, :B] = tl
    arr[:B, B:B + w] = ts[cidx][None, :]
    arr[:B, B + w:] = tr
    arr[B + h:, :B] = bl
    arr[B + h:, B:B + w] = bs[cidx][None, :]
    arr[B + h:, B + w:] = br


# ---------------------------------------------------------------------------
# motion / metadata deserialization (ref: src/dsv_decoder.c:81-238)
# ---------------------------------------------------------------------------

def _pred3(left, top, topleft):
    dif = left + top - topleft
    if abs(dif - left) < abs(dif - top):
        return left
    return top


def decode_motion(r, buf, nbh, nbv, stats, blockdata):
    readers = []
    for i in range(SUB_NSUB):
        ln = r.ueg()
        r.align()
        if i in (SUB_MODE, SUB_EPRM):
            readers.append(Zbrle(buf, r.bytepos() * 8))
        else:
            readers.append(Bits(buf, r.bytepos() * 8))
        r.pos += ln * 8
        r.align()
    rle, prrle = readers[SUB_MODE], readers[SUB_EPRM]
    bx, by = readers[SUB_MV_X], readers[SUB_MV_Y]
    bim = readers[SUB_SBIM]

    n = nbh * nbv
    mx = np.zeros(n, np.int64)
    my = np.zeros(n, np.int64)
    mflags = np.zeros(n, np.int64)
    msub = np.zeros(n, np.int64)
    mdc = np.zeros(n, np.int64)
    skip = np.zeros(n, bool)
    inv_mode = stats[MODE_STAT] == ZERO_MARKER
    inv_eprm = stats[EPRM_STAT] == ZERO_MARKER
    for j in range(nbv):
        for i in range(nbh):
            idx = i + j * nbh
            if blockdata[idx] & IS_SKIP:
                mflags[idx] |= MV_SKIP
                skip[idx] = True
                blockdata[idx] |= IS_STABLE
                continue
            mode = rle.get()
            eprm = prrle.get()
            if inv_mode:
                mode = 1 - mode
            if inv_eprm:
                eprm = 1 - eprm
            if mode:
                mflags[idx] |= MV_INTRA
            if eprm:
                mflags[idx] |= MV_EPRM
            blockdata[idx] &= ~IS_STABLE
            blockdata[idx] |= (IS_EPRM if eprm else 0)
            lx = mx[i - 1 + j * nbh] if i > 0 else 0
            ly = my[i - 1 + j * nbh] if i > 0 else 0
            tx = mx[i + (j - 1) * nbh] if j > 0 else 0
            ty = my[i + (j - 1) * nbh] if j > 0 else 0
            cx = mx[i - 1 + (j - 1) * nbh] if (i > 0 and j > 0) else 0
            cy = my[i - 1 + (j - 1) * nbh] if (i > 0 and j > 0) else 0
            px = _pred3(int(lx), int(tx), int(cx))
            py = _pred3(int(ly), int(ty), int(cy))
            if mode:
                px = (px + 2) >> 2
                py = (py + 2) >> 2
            mx[idx] = bx.seg() + px
            my[idx] = by.seg() + py
            if mode:
                mx[idx] *= 4
                my[idx] *= 4
                if bim.bit():
                    msub[idx] = MASK_ALL_INTRA
                else:
                    msub[idx] = bim.bits(4)
                if bim.bit():
                    mdc[idx] = bim.bits(8) | SRC_DC_PRED
                blockdata[idx] |= IS_INTRA
            # neighbordif (ref: dsv.c:402-447)
            cmx, cmy = int(mx[idx]), int(my[idx])
            nd = 0
            if not (abs(cmx) < 2 and abs(cmy) < 2):
                vx0, vy0 = cmx, cmy
                vx1, vy1 = cmx, cmy
                if i > 0:
                    k2 = i - 1 + j * nbh
                    if (mx[k2] or my[k2]) and not skip[k2]:
                        vx0, vy0 = int(mx[k2]), int(my[k2])
                if j > 0:
                    k2 = i + (j - 1) * nbh
                    if (mx[k2] or my[k2]) and not skip[k2]:
                        vx1, vy1 = int(mx[k2]), int(my[k2])
                nd = (abs(vx0 - cmx) + abs(vy0 - cmy)
                      + abs(vx1 - cmx) + abs(vy1 - cmy)) // 3
            if nd > NDIF_THRESH:
                blockdata[idx] |= IS_STABLE
    return (mx.reshape(nbv, nbh), my.reshape(nbv, nbh),
            mflags.reshape(nbv, nbh), msub.reshape(nbv, nbh),
            mdc.reshape(nbv, nbh))


# ---------------------------------------------------------------------------
# decoder session
# ---------------------------------------------------------------------------

class ConformanceDecoder:
    def __init__(self):
        self.meta = None
        self.plane_faults = 0
        self.ref = None           # list of bordered uint8 planes
        self.arena = None         # shared-scratch emulation (see inv_sbt)

    def decode_packet(self, buf):
        """Returns ("meta"|"eos"|"pic"|"err", frame-or-None, fno)."""
        if buf[:4] != FOURCC:
            return "err", None, -1
        pkt_type = buf[5]
        r = Bits(buf, HDR_SIZE * 8)
        if pkt_type == PT_EOS:
            return "eos", None, -1
        if pkt_type == PT_META:
            m = {}
            m["width"] = r.ueg()
            m["height"] = r.ueg()
            m["subsamp"] = r.ueg()
            m["fps_num"] = r.ueg()
            m["fps_den"] = r.ueg()
            m["aspect_num"] = r.ueg()
            m["aspect_den"] = r.ueg()
            m["inter_sharpen"] = r.ueg()
            self.meta = m
            return "meta", None, -1
        if not (pkt_type & PT_PIC) or self.meta is None:
            return "err", None, -1

        has_ref = bool(pkt_type & 0x1)
        is_ref = (pkt_type & 0x6) == 0x6
        meta = self.meta
        w, h = meta["width"], meta["height"]
        subsamp = meta["subsamp"]

        r.align()
        fno = r.bits(32)
        r.align()
        blk_w = 16 << r.ueg()
        blk_h = 16 << r.ueg()
        r.align()
        stats = [ONE_MARKER] * 5
        stats[STABLE_STAT] = r.bit()
        if not has_ref:
            stats[MAINTAIN_STAT] = r.bit()
            stats[RINGING_STAT] = r.bit()
        else:
            stats[MODE_STAT] = r.bit()
            stats[EPRM_STAT] = r.bit()
        do_filter = r.bit()
        quant = r.bits(MAX_QP_BITS)
        lossless = quant == 1
        if r.bit():
            r.bits(15)
        r.align()

        nbh = -(-w // blk_w)
        nbv = -(-h // blk_h)
        nblk = nbh * nbv

        # stability blocks (ref: dsv_decoder.c:176-198)
        ln = r.ueg()
        r.align()
        rle = Zbrle(buf, r.bytepos() * 8)
        r.pos += ln * 8
        shift_bit = IS_SKIP if has_ref else IS_STABLE
        blockdata = np.zeros(nblk, np.int64)
        inv = stats[STABLE_STAT] == ZERO_MARKER
        for i in range(nblk):
            bit = rle.get()
            if inv:
                bit = 1 - bit
            blockdata[i] = bit * shift_bit

        mv = None
        if has_ref:
            r.align()
            mv = decode_motion(r, buf, nbh, nbv, stats, blockdata)
        else:
            # ringing / maintain masks (ref: dsv_decoder.c:201-238)
            r.align()
            ln = r.ueg()
            r.align()
            rle_r = Zbrle(buf, r.bytepos() * 8)
            r.pos += ln * 8
            r.align()
            ln = r.ueg()
            r.align()
            rle_m = Zbrle(buf, r.bytepos() * 8)
            r.pos += ln * 8
            inv_r = stats[RINGING_STAT] == ZERO_MARKER
            inv_m = stats[MAINTAIN_STAT] == ZERO_MARKER
            for i in range(nblk):
                bitr = rle_r.get()
                bitm = rle_m.get()
                if inv_r:
                    bitr = 1 - bitr
                if inv_m:
                    bitm = 1 - bitm
                blockdata[i] |= (bitm * IS_MAINTAIN) | (bitr * IS_RINGING)
        r.align()

        cdims = coef_dims(subsamp, w, h)
        pdims = plane_dims(subsamp, w, h)
        psyHH = spatial_psy_factor(nbh, nbv, blk_w, blk_h, HH)

        planes_px = []
        for c in range(3):
            cw, ch = cdims[c]
            r.align()
            plen = r.bits(32)
            r.align()
            start = r.bytepos()
            # plane-length sanity + bounded scan + EOP error detection,
            # then resync to the plane boundary; a bad plane skips its
            # inverse transform and decode continues (ref:
            # dsv28dec.h:3118-3152, :3540-3550)
            ok = 0 < plen < cw * ch * 4 * 2 and start + plen <= len(buf)
            v = ll = None
            if ok:
                try:
                    ll = r.seg()
                    r.align()
                    segments = scan_segments(cw, ch)
                    v = scan_decode(r, segments)
                    r.align()  # hzcc_dec aligns before EOP (hzcc.c:581)
                    if r.bits(8) != EOP_SYMBOL:
                        ok = False
                    elif r.pos != (start + plen) * 8:
                        self.plane_faults += 1
                except CorruptStream:
                    ok = False
            if not ok:
                self.plane_faults += 1
                # inverse skipped: the plane stays at its calloc'd zeros
                planes_px.append(np.full((ch, cw), -128, np.int64))
                r.pos = min(start + max(plen, 0), len(buf)) * 8
                continue
            r.pos = (start + plen) * 8
            coefs = dequantize(v, blockdata, quant, ll, cw, ch,
                               c == 0, has_ref, lossless,
                               nbh, nbv, blk_w, blk_h, subsamp)
            if self.arena is None:
                self.arena = np.zeros(3 * self.meta["width"], np.int64)
            px = inv_sbt(coefs, blockdata, quant, cw, ch, c == 0,
                         has_ref, lossless, nbh, nbv, arena=self.arena)
            planes_px.append(px)

        fq = compute_filter_q(quant, psyHH)
        fthresh = 32 * (14 - lb2(fq))

        out = []
        if has_ref:
            tmc = fno % 2
            mvx, mvy, mflags, msub, mdc = mv
            for c in range(3):
                pw, ph = pdims[c]
                sh_ = _hsh(subsamp) if c else 0
                sv_ = _vsh(subsamp) if c else 0
                bw, bh = blk_w >> sh_, blk_h >> sv_
                pred = predict_plane(self.ref[c], mvx, mvy, mflags,
                                     msub, mdc, tmc, pw, ph, bw, bh,
                                     nbh, nbv, sh_, sv_, c == 0)
                res = np.zeros((nbv * bh, nbh * bw), np.uint8)
                res[:ph, :pw] = np.clip(
                    planes_px[c][:ph, :pw] + 128, 0, 255).astype(np.uint8)
                rec = reconstruct(res, pred, mflags, bw, bh, lossless)
                arr = np.zeros((ph + 2 * B, pw + 2 * B), np.uint8)
                arr[B:B + ph, B:B + pw] = rec[:ph, :pw]
                out.append(arr)
            if not lossless:
                vis0 = out[0][B:B + pdims[0][1], B:B + pdims[0][0]]
                luma_filter(vis0, pdims[0][0], pdims[0][1], mvx, mvy,
                            mflags, msub, nbh, nbv, blk_w, blk_h,
                            fq, fthresh, do_filter, tmc,
                            meta["inter_sharpen"])
                for c in (1, 2):
                    pw, ph = pdims[c]
                    sh_, sv_ = _hsh(subsamp), _vsh(subsamp)
                    visc = out[c][B:B + ph, B:B + pw]
                    chroma_filter(visc, pw, ph, mvx, mvy, mflags,
                                  nbh, nbv, blk_w >> sh_, blk_h >> sv_,
                                  quant)
        else:
            for c in range(3):
                pw, ph = pdims[c]
                px = np.clip(planes_px[c][:ph, :pw] + 128, 0, 255)
                arr = np.zeros((ph + 2 * B, pw + 2 * B), np.uint8)
                arr[B:B + ph, B:B + pw] = px.astype(np.uint8)
                out.append(arr)
            if not lossless and do_filter:
                vis0 = out[0][B:B + pdims[0][1], B:B + pdims[0][0]]
                intra_filter(vis0, pdims[0][0], pdims[0][1], blockdata,
                             nbh, nbv, fq, fthresh)

        if is_ref:
            self.ref = [a.copy() for a in out]
            for c in range(3):
                pw, ph = pdims[c]
                extend_border(self.ref[c], pw, ph)
        vis = [out[c][B:B + pdims[c][1], B:B + pdims[c][0]]
               for c in range(3)]
        return "pic", vis, fno

def _packet_iter(stream):
    while True:
        hdr = stream.read(HDR_SIZE)
        if len(hdr) < HDR_SIZE or hdr[:4] != FOURCC:
            return
        size = struct.unpack_from(">I", hdr, NEXT_OFF)[0]
        if size == 0:
            size = HDR_SIZE
        if size < HDR_SIZE:
            return
        rest = stream.read(size - HDR_SIZE)
        if len(rest) < size - HDR_SIZE:
            return
        yield hdr[5], hdr + rest


def _decode_packet_robust(dec, buf):
    """decode_packet that reports corrupt packets instead of raising:
    the reference decodes whatever the garbage bits say and moves on
    (dsv_decoder.c:516-523 semantics); the twin skips the packet when
    the corruption escapes the per-plane guards."""
    try:
        return dec.decode_packet(buf)
    except (CorruptStream, IndexError, ValueError, KeyError):
        return "err", None, -1


def decode_stream(stream):
    """Yields (fno, [y, u, v]) visible planes per decoded picture."""
    dec = ConformanceDecoder()
    for t, buf in _packet_iter(stream):
        kind, vis, fno = _decode_packet_robust(dec, buf)
        if kind == "eos":
            return
        if kind == "pic":
            yield fno, vis


def decode_file(path, out_path=None):
    """Decode a .dsv file; optionally write frames as y4m to out_path."""
    frames = []
    with open(path, "rb") as f:
        dec = ConformanceDecoder()
        wr = None
        for t, buf in _packet_iter(f):
            kind, vis, fno = _decode_packet_robust(dec, buf)
            if kind == "eos":
                break
            if kind != "pic":
                continue
            if out_path is not None:
                if wr is None:
                    wr = open(out_path, "wb")
                    m = dec.meta
                    cs = {0x5: "C420", 0x4: "C422", 0x14: "C422",
                          0x0: "C444", 0x8: "C411", 0xA: "C410"}
                    tag = cs.get(m["subsamp"], "C420")
                    wr.write(b"YUV4MPEG2 W%d H%d F%d:%d A%d:%d Ip %s\n"
                             % (m["width"], m["height"], m["fps_num"],
                                m["fps_den"], m["aspect_num"],
                                m["aspect_den"], tag.encode()))
                wr.write(b"FRAME\n")
                for p in vis:
                    wr.write(p.tobytes())
            else:
                frames.append((fno, vis))
        if wr is not None:
            wr.close()
    return frames
