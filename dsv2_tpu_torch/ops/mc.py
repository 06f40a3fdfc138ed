"""Block motion compensation as per-pixel gather programs (device).

Port of `dsv2_tpu/ops/mc.py` (ref: src/bmc.c:661-1055): `make_predict`,
`make_subtract` (encoder) and `make_reconstruct`. Every output pixel
computes its source coordinates from the broadcast MV field and gathers
what it needs — the quarter-pel two-pass 4-tap filter becomes 16 gathers plus
elementwise arithmetic over the whole plane, intra DC fills become
block-window reductions, and mode selection is a per-pixel select.

Gathers clamp their indices by hand, as the twin's do: torch raises on an
index out of range where JAX clamps.

Every function takes leading (lane) dimensions: the planes (..., h, w),
the MV maps (..., nbv, nbh) and tmc (...) of a lockstep flush's lanes
(the twin vmaps the one-plane function); each lane's gathers clamp into
its own plane. Without leading dimensions they are the one-plane
functions.
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as K
from .tint import on_device

B = K.FRAME_BORDER
_I32 = torch.int32


class McCfg(NamedTuple):
    w: int            # visible plane dims
    h: int
    bw: int           # block dims in this plane
    bh: int
    nbh: int
    nbv: int
    sh: int           # chroma shifts (0 for luma)
    sv: int
    is_luma: bool
    lossless: bool

    @property
    def gw(self):
        return self.nbh * self.bw

    @property
    def gh(self):
        return self.nbv * self.bh


@functools.lru_cache(maxsize=None)
def _grids(cfg):
    jj = np.repeat(np.arange(cfg.nbv), cfg.bh)
    ii = np.repeat(np.arange(cfg.nbh), cfg.bw)
    ly = (np.arange(cfg.gh) % cfg.bh)
    lx = (np.arange(cfg.gw) % cfg.bw)
    return jj, ii, ly, lx


@functools.lru_cache(maxsize=None)
def _qidx(cfg):
    """Static per-pixel quadrant index (0..3) inside each block."""
    _, _, ly, lx = _grids(cfg)
    sbw, sbh = cfg.bw // 2, cfg.bh // 2
    return ((ly >= sbh).astype(np.int64)[:, None] * 2
            + (lx >= sbw).astype(np.int64)[None, :])


def _bcast(m, cfg):
    """(..., nbv, nbh) per-block map -> (..., gh, gw) per-pixel map."""
    jj, ii, _, _ = on_device(m.device, _grids, cfg)
    return m[..., jj, :][..., ii]


def _hpf_a(a, b, c, d):
    return 19 * (b + c) - 3 * (a + d)


def _hpf_b(a, b, c, d):
    return 20 * (b + c) - 4 * (a + d)


_BF_SHIFT = K.HP_SHF + 1      # 6
_BF_MULADD = 1 << K.HP_SHF    # 32


def _qp_blend(f, b, c, phase):
    """Quarter-pel linear blend (ref: bmc.c:700-723); phase in 0..3."""
    cases = [
        (_BF_MULADD * 2 * b + _BF_MULADD) >> _BF_SHIFT,
        (f + _BF_MULADD * b + _BF_MULADD) >> _BF_SHIFT,
        (f * 2 + _BF_MULADD) >> _BF_SHIFT,
        (f + _BF_MULADD * c + _BF_MULADD) >> _BF_SHIFT,
    ]
    return torch.where(phase == 0, cases[0],
                       torch.where(phase == 1, cases[1],
                                   torch.where(phase == 2, cases[2],
                                               cases[3])))


def _win_gather(ref, offy, offx, wh, ww):
    """One gather of per-block (wh, ww) windows: out[..., j, i, r, c] =
    ref[..., clip(offy[..., j, i] + r), clip(offx[..., j, i] + c)] — MV
    offsets are constant per block, so every tap is a static slice of
    this canvas. Leading dimensions index planes: each clamps into its
    own."""
    dev = ref.device
    hp, wp = ref.shape[-2:]
    ry = torch.clamp(offy[..., None]
                     + torch.arange(wh, dtype=_I32, device=dev),
                     0, hp - 1).long()
    rx = torch.clamp(offx[..., None]
                     + torch.arange(ww, dtype=_I32, device=dev),
                     0, wp - 1).long()
    idx = ry[..., :, None] * wp + rx[..., None, :]
    flat = ref.reshape(-1, hp * wp)
    n = flat.shape[0]
    lane = torch.arange(n, device=dev).reshape((n,) + (1,) * 4)
    out = flat[lane, idx.reshape((n,) + idx.shape[-4:])]
    return out.reshape(idx.shape).to(_I32)


def _blocks_to_plane(bk, cfg):
    """(..., nbv, nbh, bh, bw) block tensor -> (..., gh, gw) plane."""
    lead = bk.shape[:-4]
    nd = len(lead)
    return bk.permute(tuple(range(nd)) + (nd, nd + 2, nd + 1, nd + 3)
                      ).reshape(lead + (cfg.gh, cfg.gw))


def _block_mean(x, n):
    return torch.div(x.sum(dim=(-1, -2), dtype=_I32), n,
                     rounding_mode="floor")


@functools.lru_cache(maxsize=None)
def make_predict(cfg: McCfg):
    """Returns fn(ref bordered uint8 (..., h+2B, w+2B), mvx, mvy, flags,
    submask, dc, tmc) -> prediction canvas (..., gh, gw) uint8. The MV
    maps are (..., nbv, nbh) int32; tmc is an int, a one-value int32
    tensor, or one value per lane (...)."""
    limx = cfg.w - cfg.bw + B - 1
    limy = cfg.h - cfg.bh + B - 1
    sbw, sbh = cfg.bw // 2, cfg.bh // 2
    # chroma fractional setup (ref: bmc.c:771-812)
    hbits, vbits = 2 + cfg.sh, 2 + cfg.sv
    hf, vf = 1 << hbits, 1 << vbits
    sf = hbits + vbits
    af = 1 << (sf - 1)

    def f(ref, mvx, mvy, flags, submask, dc, tmc):
        dev = ref.device
        ibase = torch.arange(cfg.nbh, dtype=_I32, device=dev) * cfg.bw
        jbase = torch.arange(cfg.nbv, dtype=_I32, device=dev) * cfg.bh
        pxb = ibase[None, :] + (mvx >> (2 + cfg.sh))
        pyb = jbase[:, None] + (mvy >> (2 + cfg.sv))
        # whole-pel / intra-copy source offsets (ref: bmc.c:850-851, 905-906)
        offx_w = torch.clamp(pxb, -B, limx) + B
        offy_w = torch.clamp(pyb, -B, limy) + B

        def bb(m):  # per-block -> block-tensor broadcast
            return m[..., None, None]

        if cfg.is_luma:
            wins = _win_gather(ref, offy_w, offx_w, cfg.bh, cfg.bw)
            wholepel = _blocks_to_plane(wins, cfg)
            # subpel two-pass 4-tap + quarter-pel blend (ref: bmc.c:661-769)
            offx_s = torch.clamp(pxb - 1, -B, limx) + B
            offy_s = torch.clamp(pyb - 1, -B, limy) + B
            C = _win_gather(ref, offy_s, offx_s, cfg.bh + 3, cfg.bw + 3)
            large = (mvx.abs() >= 8) | (mvy.abs() >= 8)
            dxp = mvx & 3
            dyp = mvy & 3
            tmc_odd = (tmc & 1) != 0
            if isinstance(tmc_odd, torch.Tensor):   # one value, or per lane
                tmc_odd = (tmc_odd.reshape(()) if tmc_odd.numel() == 1
                           else tmc_odd[..., None, None])
            dqtx = bb(large | ((dxp & 1) == 0) | tmc_odd)
            dqty = bb(large | ((dyp & 1) == 0) | tmc_odd)
            rows = []
            for t in range(4):
                a, b, c, d = (C[..., t:t + cfg.bh, k:k + cfg.bw]
                              for k in range(4))
                fv = torch.where(dqtx, _hpf_a(a, b, c, d),
                                 _hpf_b(a, b, c, d))
                rows.append(_qp_blend(fv, b, c, bb(dxp)))
            fv = torch.where(dqty, _hpf_a(*rows), _hpf_b(*rows))
            subpel = torch.clamp(_qp_blend(fv, rows[1], rows[2], bb(dyp)),
                                 0, 255)
            is_subpel = bb(((mvx | mvy) & 3) != 0)
            inter = _blocks_to_plane(torch.where(is_subpel, subpel, wins),
                                     cfg)
        else:
            C = _win_gather(ref, offy_w, offx_w, cfg.bh + 1, cfg.bw + 1)
            wins = C[..., :cfg.bh, :cfg.bw]
            wholepel = _blocks_to_plane(wins, cfg)
            dxc = mvx & (hf - 1)
            dyc = mvy & (vf - 1)
            f0 = (hf - dxc) * (vf - dyc)
            f1 = dxc * (vf - dyc)
            f2 = (hf - dxc) * dyc
            f3 = dxc * dyc
            p01 = C[..., :cfg.bh, 1:cfg.bw + 1]
            p10 = C[..., 1:cfg.bh + 1, :cfg.bw]
            p11 = C[..., 1:cfg.bh + 1, 1:cfg.bw + 1]
            inter = _blocks_to_plane(
                (bb(f0) * wins + bb(f1) * p01 + bb(f2) * p10
                 + bb(f3) * p11 + af) >> sf, cfg)

        intra_b = (flags & (1 << K.MV_BIT_INTRA)) != 0

        # intra fills (ref: bmc.c:845-900) — windows ARE the whole-pel
        # canvas blocks (same clamped offsets), so no extra gather
        full_avg = _block_mean(wins, cfg.bw * cfg.bh)
        q_avg = torch.stack([
            _block_mean(wins[..., g:g + sbh, fx:fx + sbw], sbw * sbh)
            for g in (0, sbh) for fx in (0, sbw)], dim=-3)  # (..., 4, v, h)

        if cfg.is_luma:
            has_dc = dc != 0
        else:
            has_dc = torch.zeros_like(dc, dtype=torch.bool)
        dc_val = dc & 0xFF
        fill_all = torch.where(has_dc, dc_val, full_avg)
        fill_q = torch.where(has_dc[..., None, :, :], dc_val[..., None, :, :],
                             q_avg)

        qidx = on_device(dev, _qidx, cfg)
        fill_q_pix = _bcast(fill_q, cfg).gather(
            -3, qidx.expand(fill_q.shape[:-3] + (1,) + qidx.shape))[..., 0,
                                                                     :, :]
        qmask_pix = ((_bcast(submask, cfg) >> qidx.to(_I32)) & 1) != 0
        all_intra = _bcast(submask == K.MASK_ALL_INTRA, cfg)
        intra_pix = torch.where(
            all_intra, _bcast(fill_all, cfg),
            torch.where(qmask_pix, fill_q_pix, wholepel))

        out = torch.where(_bcast(intra_b, cfg), intra_pix, inter)
        return out.to(torch.uint8)

    return f


@functools.lru_cache(maxsize=None)
def make_subtract(cfg: McCfg):
    """Returns fn(res uint8 (..., gh, gw), pred uint8 (..., gh, gw), flags
    (..., nbv, nbh) int32) -> the residual canvas uint8, per-block modes
    (ref: bmc.c:989-1055)."""

    def f(res, pred, flags):
        r = res.to(_I32)
        p = pred.to(_I32)
        if cfg.lossless:
            return ((r - p + 128) & 0xFF).to(torch.uint8)
        intra = (flags & (1 << K.MV_BIT_INTRA)) != 0
        skip = (flags & (1 << K.MV_BIT_SKIP)) != 0
        noxmit = (flags & (1 << (K.MV_BIT_NOXMITY if cfg.is_luma
                                 else K.MV_BIT_NOXMITC))) != 0
        eprm = (flags & (1 << K.MV_BIT_EPRM)) != 0
        zero_b = _bcast(~intra & (skip | noxmit), cfg)
        eprm_p = _bcast(eprm, cfg)
        normal = torch.clamp(r - p + 128, 0, 255)
        halved = torch.clamp((r - p + 256) >> 1, 0, 255)
        out = torch.where(zero_b, 128, torch.where(eprm_p, halved, normal))
        return out.to(torch.uint8)

    return f


@functools.lru_cache(maxsize=None)
def make_reconstruct(cfg: McCfg):
    """Returns fn(res uint8 (..., gh, gw), pred uint8 (..., gh, gw), flags
    (..., nbv, nbh) int32) -> reconstructed canvas uint8, per-block modes
    (ref: bmc.c:925-987)."""

    def f(res, pred, flags):
        r = res.to(_I32)
        p = pred.to(_I32)
        if cfg.lossless:
            return ((p + r - 128) & 0xFF).to(torch.uint8)
        intra = (flags & (1 << K.MV_BIT_INTRA)) != 0
        skip = (flags & (1 << K.MV_BIT_SKIP)) != 0
        eprm = (flags & (1 << K.MV_BIT_EPRM)) != 0
        use_eprm = _bcast(eprm & ~(~intra & skip), cfg)
        normal = torch.clamp(p + r - 128, 0, 255)
        doubled = torch.clamp(p + (r - 128) * 2, 0, 255)
        return torch.where(use_eprm, doubled, normal).to(torch.uint8)

    return f
