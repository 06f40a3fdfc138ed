"""Whole-frame device steps: intra encode and decode.

Port of two parts of `dsv2_tpu/codec/devsteps.py`.

Intra encode (blob transfer): the per-plane forward SBT -> quantize ->
scan blob chain, the blob merge (`_finish_blob`), the single-frame step
of the sequential session (`make_i_encode_step`, reconstruction-free:
gop=0 keeps no reference) and its host fetch (`fetch_sparse_outs`).
Every function takes a leading frame dimension; the sequential step is
the batch of one. The batched pipeline (parallel/batch.py) runs the same
`encode_planes`.

Decode (device chain): dequantize -> inverse SBT -> (P) motion
compensation and reconstruction -> in-loop filters -> border extension
into the device reference chain, plus the compact scan upload
(`compact_vs` on the host, `_expand_vs` on the device). The intra steps
take a leading frame dimension (the twin's vmap over K frames is that
dimension here); the P steps take one frame, and the K-frame P chain is
a Python loop with the reference kept on the device (the twin's
lax.scan). The decoder-arena steps are not ported (ROADMAP item 18).
"""
import functools

import numpy as np
import torch

from ..ops import filters, framedev, hzcc, mc, scan_pl, sbt
from ..parallel import xfer
from ..utils.packet import VideoMeta
from .decoder import _PCfg


def blob_cap(total):
    """Static byte capacity of one plane's device scan blob. Typical
    entropy-coded planes run ~0.1-0.3 bytes/coefficient; over-cap content
    raises the per-plane fallback (host re-scan), so the cap trades
    emission work against fallback rate."""
    return max(-(-total // 3), 4096)


def _finish_blob(lls, vs, pcfg):
    """Each plane's FINAL entropy-coded scan blob (ops/scan_pl), merged
    into one flat byte buffer at cumsum offsets (plane-major, then frame).
    lls[c] (nfr,) int32 DC coefficients; vs[c] (nfr, total_c) int32 scans.
    Returns (buf, smalls): smalls is int32 [c][field][frame] with fields
    (nbytes, ll, nbytes, fallback); a fallback plane has nbytes 0 and is
    re-coded on the host from its int32 scan."""
    rows, useds, fbs = [], [], []
    for c, v in enumerate(vs):
        segs = tuple(hzcc.scan_segments(*pcfg.cdims[c]))
        total = sum(n for n, _ in segs)
        blob, nbytes, fb = scan_pl.make_scan_blob(segs, blob_cap(total))(v)
        rows.append(blob)
        useds.append(torch.where(fb, 0, nbytes))
        fbs.append(fb)
    buf, _ = xfer.merge_rows(rows, useds)
    smalls = torch.cat([torch.cat([useds[c], lls[c], useds[c],
                                   fbs[c].to(torch.int32)])
                        for c in range(3)])
    return buf, smalls


def encode_planes(pcfg, xs, bd, q):
    """xs: three (nfr, ch, cw) uint8 coefficient-dim planes; bd (nfr, nbv,
    nbh) uint8 blockdata; q (nfr,) int32. Returns (lls, vs) per plane: the
    unquantized DC coefficient (nfr,) and the quantized scan (nfr,
    total)."""
    lls, vs = [], []
    for c in range(3):
        x = xs[c].to(torch.int32) - 128
        coefs, _ = sbt.make_fwd_sbt_carry(pcfg.sbt_cfg(c))(x, bd)
        _, v = hzcc.make_quantize(pcfg.hzcc_cfg(c))(coefs, bd, q)
        lls.append(coefs[:, 0, 0])
        vs.append(v)
    return lls, vs


@functools.lru_cache(maxsize=None)
def make_i_encode_step(w, h, subsamp, blk_w, blk_h, lossless, do_psy):
    """Single-frame intra step of the sequential session, without
    reconstruction: step(xs, bd, q) -> (buf, smalls, vs) with the
    _finish_blob layout for nfr = 1."""
    pcfg = _PCfg(VideoMeta(width=w, height=h, subsamp=subsamp),
                 blk_w, blk_h, False, lossless, do_psy)

    def step(xs, bd, q):
        lls, vs = encode_planes(pcfg, xs, bd, q)
        buf, smalls = _finish_blob(lls, vs, pcfg)
        return buf, smalls, vs

    return step


def fetch_sparse_outs(step_out):
    """Host fetch of a one-frame step's outputs: the metadata, then one
    copy of the occupied blob prefix. Returns (vscans, lls) per plane,
    each vscan ("blob", bytes of the device blob) or, on the per-plane
    contract fallback, ("dense", the int32 scan array)."""
    buf, smalls, vs = step_out
    sm = smalls.cpu().numpy().reshape(3, 4)
    useds = sm[:, 2].astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(useds)[:-1]])
    packed = xfer.slice_packed(buf, int(useds.sum())).cpu().numpy()
    vscans, lls = [], []
    for c in range(3):
        _, ll, used, fb = (int(x) for x in sm[c])
        if fb:
            vscans.append(("dense", vs[c][0].cpu().numpy()))
        else:
            o = int(offs[c])
            vscans.append(("blob", packed[o:o + used]))
        lls.append(ll)
    return vscans, lls


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _pcfg(w, h, subsamp, blk_w, blk_h, isP, lossless):
    return _PCfg(VideoMeta(width=w, height=h, subsamp=subsamp),
                 blk_w, blk_h, isP, lossless, 0)


def _clip_u8(px):
    return torch.clamp(px + 128, 0, 255).to(torch.uint8)


def _decode_pixels(pcfg, vs, bd, q, lls):
    """Per plane: dequantize + inverse SBT -> clamped pixels uint8[...,
    ch, cw]. vs[c] int32[..., total], bd uint8[..., nbv, nbh], q int32[...],
    lls int32[..., 3]."""
    outs = []
    for c in range(3):
        coefs = hzcc.make_dequantize(pcfg.hzcc_cfg(c))(vs[c], bd, q,
                                                       lls[..., c])
        outs.append(_clip_u8(sbt.make_inv_sbt(pcfg.sbt_cfg(c))(coefs, bd,
                                                                 q)))
    return outs


@functools.lru_cache(maxsize=None)
def make_i_decode_step(w, h, subsamp, blk_w, blk_h, lossless):
    """step(vs, bd, q, lls) -> the three planes' pixels uint8[..., ch, cw]
    (dequantize + inverse SBT; leading frame dimensions ride along)."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)
    return functools.partial(_decode_pixels, pcfg)


@functools.lru_cache(maxsize=None)
def make_p_decode_step(w, h, subsamp, blk_w, blk_h, lossless):
    """Dequant + inverse SBT + MC prediction + reconstruction of one frame
    (ref: dsv_decoder.c:512-549). step(vs, bd, q, lls, refs, mvx, mvy,
    flags, submask, dc, tmc) -> per plane the reconstructed canvas uint8
    (gh, gw); refs are the bordered reference planes."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, True, lossless)

    def step(vs, bd, q, lls, refs, mvx, mvy, flags, submask, dc, tmc):
        pxs = _decode_pixels(pcfg, vs, bd, q, lls)
        outs = []
        for c in range(3):
            mcc = pcfg.mc_cfg(c)
            pw, ph = pcfg.pdims[c]
            res = torch.zeros((mcc.gh, mcc.gw), dtype=torch.uint8,
                              device=pxs[c].device)
            res[:ph, :pw] = pxs[c][:ph, :pw]
            pred = mc.make_predict(mcc)(refs[c], mvx, mvy, flags, submask,
                                        dc, tmc)
            outs.append(mc.make_reconstruct(mcc)(res, pred, flags))
        return outs

    return step


_NFIX = 64


def _ll_ns(pcfg):
    """Static LL-band lengths (scan segment 0) per plane."""
    return tuple(hzcc.scan_segments(*pcfg.cdims[c])[0][0] for c in range(3))


def compact_vs(pcfg, vs, lossless):
    """Host side of the compact scan upload for the chain decode: each
    dense int32 scan vector ships as (LL prefix int32[ll_n], HF tail int8,
    fixups). HF values are |v| <= 127 in almost every slot, but legal
    streams do exceed it occasionally (intra frames at low qp); those
    slots ship clamped in the int8 tail plus a <= _NFIX-entry (pos, true
    value) patch list whose unused entries hold the out-of-range position
    len(tail). Returns None when a plane needs more than _NFIX patches.
    Lossless streams keep dense vectors (full-range values)."""
    if lossless:
        return tuple(vs)
    lln = _ll_ns(pcfg)
    out = []
    for c in range(3):
        v = np.asarray(vs[c])
        n = lln[c]
        hf = v[n:]
        over = np.nonzero((hf > 127) | (hf < -127))[0]
        if over.size > _NFIX:
            return None
        fpos = np.full(_NFIX, hf.size, np.int32)   # out of range: dropped
        fval = np.zeros(_NFIX, np.int32)
        fpos[:over.size] = over
        fval[:over.size] = hf[over]
        out.append((v[:n].astype(np.int32),
                    np.clip(hf, -127, 127).astype(np.int8), fpos, fval))
    return tuple(out)


def _expand_vs(vs, lossless):
    """Device side of compact_vs: sign-extend the int8 tail and patch the
    fixups, over leading frame dimensions. The twin's scatter drops the
    out-of-range positions (mode="drop"); torch has no such mode, so they
    are sent to one scratch slot past the tail, cut off afterwards."""
    if lossless:
        return vs
    out = []
    for (llv, hf, fpos, fval) in vs:
        m = hf.shape[-1]
        hfi = torch.cat([hf.to(torch.int32),
                         hf.new_zeros(hf.shape[:-1] + (1,),
                                      dtype=torch.int32)], dim=-1)
        pos = torch.where((fpos >= 0) & (fpos < m), fpos, m).long()
        hfi.scatter_(-1, pos, fval)
        out.append(torch.cat([llv.to(torch.int32), hfi[..., :m]], dim=-1))
    return tuple(out)


def _visible(pcfg, planes):
    return [planes[c][..., :pcfg.pdims[c][1], :pcfg.pdims[c][0]]
            for c in range(3)]


def _packed(vis):
    """One flat visible payload per frame: a single fetch."""
    return torch.cat([v.reshape(v.shape[:-2] + (-1,)) for v in vis], dim=-1)


def _chain(pcfg, vis):
    return {"recon": [framedev.extend_plane_graph(vis[c], *pcfg.pdims[c])
                      for c in range(3)]}


def _id_visible(pcfg, lossless, vs, bd, q, lls, fq, fthresh, do_filter):
    """Intra decode + intra dering filter -> visible planes (shared body
    of the single-frame chain step and the K-frame step)."""
    meta = pcfg.meta
    base = make_i_decode_step(meta.width, meta.height, meta.subsamp,
                              pcfg.blk_w, pcfg.blk_h, lossless)
    vis = _visible(pcfg, base(_expand_vs(vs, lossless), bd, q, lls))
    if not lossless:
        vis[0] = filters.intra_filter_graph(
            pcfg.pdims[0][0], pcfg.pdims[0][1], pcfg.nbh, pcfg.nbv, vis[0],
            bd, fq, fthresh * do_filter)
    return vis


@functools.lru_cache(maxsize=None)
def make_id_chain_step(w, h, subsamp, blk_w, blk_h, lossless):
    """Intra decode + device reference chain: recon -> intra dering filter
    -> border extension. step(vs, bd, q, lls, fq, fthresh, do_filter) ->
    (packed visible payload uint8, {"recon": bordered planes}) (ref:
    dsv_decoder.c:512-549 + bmc.c:390-457)."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)

    def step(vs, bd, q, lls, fq, fthresh, do_filter):
        vis = _id_visible(pcfg, lossless, vs, bd, q, lls, fq, fthresh,
                          do_filter)
        return _packed(vis), _chain(pcfg, vis)

    return step


@functools.lru_cache(maxsize=None)
def make_pd_chain_step(w, h, subsamp, blk_w, blk_h, lossless,
                       inter_sharpen):
    """P decode + device reference chain: recon -> in-loop luma/chroma
    filters -> border extension, one frame; refs are the previous frame's
    chain planes (ref: dsv_decoder.c:512-549 + bmc.c:459-659)."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, True, lossless)
    base = make_p_decode_step(w, h, subsamp, blk_w, blk_h, lossless)

    def step(vs, bd, q, lls, refs, mvx, mvy, flags, submask, dc, tmc,
             fq, fthresh, do_filter):
        vis = _visible(pcfg, base(_expand_vs(vs, lossless), bd, q, lls,
                                  refs, mvx, mvy, flags, submask, dc, tmc))
        if not lossless:
            vis[0] = filters.luma_filter_graph(
                pcfg.pdims[0][0], pcfg.pdims[0][1], pcfg.nbh, pcfg.nbv,
                blk_w, blk_h, inter_sharpen, vis[0], mvx, mvy, flags,
                submask, fq, fthresh, do_filter, tmc)
            for c in (1, 2):
                mcc = pcfg.mc_cfg(c)
                vis[c] = filters.chroma_filter_graph(
                    pcfg.pdims[c][0], pcfg.pdims[c][1], pcfg.nbh, pcfg.nbv,
                    mcc.bw, mcc.bh, vis[c], mvx, mvy, flags, q)
        return _packed(vis), _chain(pcfg, vis)

    return step


@functools.lru_cache(maxsize=None)
def make_pd_chain_multi(w, h, subsamp, blk_w, blk_h, lossless,
                        inter_sharpen):
    """K-frame P decode: the single-frame chain step over stacked per-frame
    inputs (leading dimension K), the reference threaded from frame to
    frame on the device. Returns ((K, npix) payload, {"recon": the last
    frame's chain})."""
    single = make_pd_chain_step(w, h, subsamp, blk_w, blk_h, lossless,
                                inter_sharpen)

    def step(vs, bd, q, lls, refs, mvx, mvy, flags, submask, dc, tmc,
             fq, fthresh, do_filter):
        carry = tuple(refs)
        packeds = []
        for k in range(bd.shape[0]):
            vs_k = tuple(tuple(a[k] for a in p) if isinstance(p, tuple)
                         else p[k] for p in vs)
            packed, chain = single(vs_k, bd[k], q[k], lls[k], carry,
                                   mvx[k], mvy[k], flags[k], submask[k],
                                   dc[k], tmc[k], fq[k], fthresh[k],
                                   do_filter[k])
            carry = tuple(chain["recon"])
            packeds.append(packed)
        return torch.stack(packeds), {"recon": list(carry)}

    return step


@functools.lru_cache(maxsize=None)
def make_id_chain_multi(w, h, subsamp, blk_w, blk_h, lossless):
    """K-frame intra decode of independent (non-ref) frames: the leading
    dimension K is the batch of every op, the intra filter runs the K
    luma planes in one wavefront, and the reference chain is not built
    (non-ref frames never need it). Returns the (K, npix) payload."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)

    def step(vs, bd, q, lls, fq, fthresh, do_filter):
        return _packed(_id_visible(pcfg, lossless, vs, bd, q, lls, fq,
                                   fthresh, do_filter))

    return step
