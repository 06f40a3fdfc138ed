"""Whole-frame device steps: encode and decode.

Port of `dsv2_tpu/codec/devsteps.py`.

Intra encode (blob transfer): the per-plane forward SBT -> quantize ->
scan blob chain, the blob merge (`_finish_blob`), the single-frame step
of the sequential session at -gop=0 (`make_i_encode_step`) and its host
fetch (`fetch_sparse_outs`). Every intra function takes a leading frame
dimension; the sequential step is the batch of one. The batched pipeline
(parallel/batch.py) runs the same `encode_planes`.

A device step of the encoder's reference chain (gop != 0) and of the
decoder is a builder of the lanes of a flush: builder(cfg) -> fn(lanes),
`lanes` the argument tuples of the lanes, fn returning one output per
lane (the contract of parallel/dynbatch). The lanes run stacked on a
leading dimension: one vk launch per plane and one filter launch per
filter kind for all of them, as the twin's vmap. The encode steps are
the input prep (`make_input_prep_lanes`: bordered planes + motion
search pyramid) and the chain steps (`make_i_chain_lanes`,
`make_p_chain_lanes`: MC prediction -> residual -> forward SBT ->
quantize -> in-loop inverse -> reconstruction for P, then the in-loop
filters, border extension and the pyramid, without leaving the device).
Each encode lane fetches its own part of the flush's blob
(`fetch_sparse_outs` of its LaneOut: the twin's merged per-flush fetch
exists for a TPU link's per-transfer cost and is not ported). A P lane's
per-frame values reach the step as one uploaded int32 array
(`p_chain_ints`).

Under lockstep the batcher runs a flush of every lane that reached a
step; outside it a step is a flush of one lane (`run_one`). On the card
a flush of the P chain, of one lane or of a lockstep flush's L, is a CUDA
graph, captured once per key and lane count and replayed for every flush
of that many lanes in the process (parallel/dynbatch.flush_step, whose
GRAPHED names the P chain): some 9,000 ops a flush become one launch.

Decode (device chain): dequantize -> inverse SBT -> (P) motion
compensation and reconstruction -> in-loop filters -> border extension
into the device reference chain, plus the scan upload (`scan_upload`:
`compact_vs` on the host and `_expand_vs` on the device, or the dense
vectors). The intra steps take a leading frame dimension (the twin's
vmap over K frames is that dimension here); the P steps take one frame,
and the K-frame P chain is a Python loop with the reference kept on the
device (the twin's lax.scan). The one-frame chain steps also take the
planes of a picture that came with a corrupt end-of-plane marker (`bad`:
the reference skips their inverse transform, so a P plane reconstructs
against an all-zero residual and an intra plane is zero before the
filter) and, at degenerate geometries (codec/decoder._needs_arena), the
decoder's arena: the reference's shared transform scratch, threaded from
plane to plane and frame to frame (`_arena_apply`).
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.frame import plane_dims
from ..ops import filters, framedev, hzcc, mc, scan_pl, sbt
from ..parallel import dynbatch, xfer
from ..utils import trace
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


def _code_plane(pcfg, c, x, bd, q, need_recon, masks=()):
    """Forward SBT -> quantize (-> in-loop inverse) of one plane x int32
    [..., ch, cw] (centered). Returns (coefs, v, recon): recon the clamped
    uint8 reconstruction [..., ch, cw] or None."""
    scfg = pcfg.sbt_cfg(c)
    coefs, cr = sbt.make_fwd_sbt_carry(scfg)(x, bd)
    deq, v = hzcc.make_quantize(pcfg.hzcc_cfg(c))(coefs, bd, q, *masks)
    if not need_recon:
        return coefs, v, None
    # fwd carry -> in-loop inverse: replicates the reference's shared
    # scratch at degenerate (extreme-aspect) levels
    rpx = sbt.make_inv_sbt_stale(scfg)(deq, bd, q, cr)
    return coefs, v, _clip_u8(rpx)


def encode_planes(pcfg, xs, bd, q, need_recon=False):
    """xs: three (nfr, ch, cw) uint8 coefficient-dim planes; bd (nfr, nbv,
    nbh) uint8 blockdata; q (nfr,) int32. Returns (lls, vs) per plane: the
    unquantized DC coefficient (nfr,) and the quantized scan (nfr,
    total); with need_recon also the reconstructed planes (nfr, ch, cw)
    uint8."""
    lls, vs, recons = [], [], []
    for c in range(3):
        coefs, v, rec = _code_plane(pcfg, c, xs[c].to(torch.int32) - 128, bd,
                                    q, need_recon)
        lls.append(coefs[:, 0, 0])
        vs.append(v)
        recons.append(rec)
    if need_recon:
        return lls, vs, recons
    return lls, vs


@functools.lru_cache(maxsize=None)
def make_i_encode_step(w, h, subsamp, blk_w, blk_h, lossless, do_psy):
    """Single-frame intra step of the sequential session at -gop=0:
    step(xs, bd, q) -> (buf, smalls, vs) with the _finish_blob layout for
    nfr = 1."""
    pcfg = _PCfg(VideoMeta(width=w, height=h, subsamp=subsamp),
                 blk_w, blk_h, False, lossless, do_psy)

    def step(xs, bd, q):
        lls, vs = encode_planes(pcfg, xs, bd, q)
        return _finish_blob(lls, vs, pcfg) + (vs,)

    return step


def _p_encode(pcfg, srcs, refs, mvx, mvy, flags, submask, dc, bd, eprm_m,
              mlt_m, q, tmc):
    """The P encode chain over leading (lane) dimensions: per plane the MC
    prediction, residual, forward SBT, quantize, in-loop inverse and
    reconstruction. srcs (..., gh, gw) uint8 canvases, refs the bordered
    reference planes, the maps (..., nbv, nbh), q and tmc (...). Returns
    (recons, lls, vs): the reconstructed canvases, the DC coefficients
    (nfr,) and scans (nfr, total) with the leading dimensions flattened."""
    recons, lls, vs = [], [], []
    for c in range(3):
        mcc = pcfg.mc_cfg(c)
        cw, ch = pcfg.cdims[c]
        pw, ph = pcfg.pdims[c]
        pred = mc.make_predict(mcc)(refs[c], mvx, mvy, flags, submask, dc,
                                    tmc)
        res = mc.make_subtract(mcc)(srcs[c], pred, flags)
        x = torch.zeros(res.shape[:-2] + (ch, cw), dtype=torch.int32,
                        device=res.device)
        x[..., :ph, :] = res[..., :ph, :cw].to(torch.int32) - 128
        coefs, v, rpx = _code_plane(pcfg, c, x, bd, q, True, (eprm_m, mlt_m))
        res2 = res.clone()
        res2[..., :ph, :pw] = rpx[..., :ph, :pw]
        recons.append(mc.make_reconstruct(mcc)(res2, pred, flags))
        lls.append(coefs[..., 0, 0].reshape(-1))
        vs.append(v.reshape(-1, v.shape[-1]))
    return recons, lls, vs


def _chain_outputs(pcfg, levels, recons):
    """Filter-free tail of a chain step: border-extend every visible recon
    plane (ph, pw) uint8 and build the luma motion search pyramid, all on
    the device (ref: dsv_encoder.c:1166-1172 + frame.c:357-434)."""
    planes = [framedev.extend_plane_graph(recons[c], *pcfg.pdims[c])
              for c in range(3)]
    rpyr = framedev.pyramid_graph(planes[0], pcfg.pdims[0][0],
                                  pcfg.pdims[0][1], levels)
    return {"recon": planes, "rpyr": rpyr}


def _chroma_filters(pcfg, vis, mvx, mvy, flags, q):
    """The inter chroma filter of U and V in one launch: both planes share
    the geometry, the motion field and q; with leading (lane) dimensions,
    the U and V of every lane, (L, 2, ph, pw), in that one launch."""
    mcc = pcfg.mc_cfg(1)
    uv = filters.chroma_filter_graph(
        pcfg.pdims[1][0], pcfg.pdims[1][1], pcfg.nbh, pcfg.nbv, mcc.bw,
        mcc.bh, torch.stack([vis[1], vis[2]], dim=-3), mvx, mvy, flags, q)
    return uv[..., 0, :, :], uv[..., 1, :, :]


def _p_filters(pcfg, inter_sharpen, vis, mvx, mvy, flags, submask, q, tmc,
               fq, fthresh, do_filter):
    """The in-loop filters of a P picture, in place on the visible planes
    vis (..., ph, pw): one luma launch, one chroma launch (U and V)."""
    if pcfg.lossless:
        return vis
    vis[0] = filters.luma_filter_graph(
        pcfg.pdims[0][0], pcfg.pdims[0][1], pcfg.nbh, pcfg.nbv, pcfg.blk_w,
        pcfg.blk_h, inter_sharpen, vis[0], mvx, mvy, flags, submask, fq,
        fthresh, do_filter, tmc)
    vis[1], vis[2] = _chroma_filters(pcfg, vis, mvx, mvy, flags, q)
    return vis


def p_chain_ints(grids, q, tmc, fq, fthresh, do_filter):
    """A P lane's per-frame values as make_p_chain_lanes takes them, one
    int32 array for one upload: grids (8, nbv, nbh) (mvx, mvy, flags,
    submask, dc, blockdata, eprm, mlt), then q, tmc, fq, fthresh and
    do_filter."""
    return np.concatenate([np.asarray(grids, np.int32).reshape(-1),
                           np.array([q, tmc, fq, fthresh, do_filter],
                                    np.int32)])


def run_one(key, builder, args, device):
    """A device step outside lockstep: a flush of one lane
    (dynbatch.flush_step), `args` that lane's arguments; returns the
    lane's output."""
    return dynbatch.lane_of(
        dynbatch.flush_step(key, builder, 1, device)([args]), 0)


class LaneOut(NamedTuple):
    """One lane's output of an encode chain step, read like the -gop=0
    step's (buf, smalls, vs) plus its chain: the flush's merged blob and
    metadata (the _finish_blob layout with one frame per lane), this
    lane's scans (1, total) per plane and device reference chain, and the
    lane's index, which fetch_sparse_outs reads its part of the blob by."""
    buf: torch.Tensor
    smalls: torch.Tensor
    vs: list
    chain: dict
    lane: int


def _lane_views(out, i):
    """Lane i of a dict of per-plane lists of (L, ...) tensors."""
    return {k: [t[i] for t in v] for k, v in out.items()}


def _stack(ts):
    """The lanes' tensors on a new leading lane dimension: a view of the
    one tensor of a flush of one lane, else a copy."""
    return ts[0].unsqueeze(0) if len(ts) == 1 else torch.stack(ts)


def _cat(ts):
    """The lanes' tensors joined along their leading dimension: the one
    tensor of a flush of one lane, else a copy."""
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _upload_ints(rows, device):
    """Per-lane Python (or numpy) ints, rows[k][i] for field k and lane i,
    as one int32 (nfields, L) tensor: one upload per flush."""
    return xfer.upload(np.asarray(rows, dtype=np.int32), device)


def _encode_lanes(buf, smalls, vs, chain, nlanes):
    return [LaneOut(buf, smalls, [v[i:i + 1] for v in vs],
                    _lane_views(chain, i), i) for i in range(nlanes)]


@functools.lru_cache(maxsize=None)
def make_input_prep_lanes(cfg):
    """The input prep of the lanes of a flush, cfg (w, h, subsamp,
    levels): lanes are each frame's visible planes (vis0, vis1, vis2),
    the per-frame upload; returns per lane {"padded": bordered planes,
    "pyr": luma motion search pyramid}, views of the flush's (L, ...)
    planes: everything derived stays on the device (ref:
    dsv_encoder.c:493-516, frame.c:357-434)."""
    w, h, subsamp, levels = cfg
    dims = plane_dims(subsamp, w, h)

    def run(lanes):
        padded = [framedev.extend_plane_graph(_stack(v), pw, ph)
                  for v, (pw, ph) in zip(zip(*lanes), dims)]
        out = {"padded": padded,
               "pyr": framedev.pyramid_graph(padded[0], w, h, levels)}
        return [_lane_views(out, i) for i in range(len(lanes))]

    return run


@functools.lru_cache(maxsize=None)
def make_i_chain_lanes(cfg):
    """Intra encode step + device reference chain of the lanes of a
    flush, cfg (w, h, subsamp, blk_w, blk_h, lossless, do_psy, levels):
    recon -> intra dering filter -> border extension -> pyramid. Lanes
    are (xs, bd, q, fq, fthresh, do_filter), xs/bd/q as for
    make_i_encode_step; one blob (one vk launch per plane) and one intra
    filter launch for every lane. Returns a LaneOut per lane, its chain
    {"recon", "rpyr"} (ref: dsv_encoder.c:1296-1301 + bmc.c:390-457)."""
    w, h, subsamp, blk_w, blk_h, lossless, do_psy, levels = cfg
    pcfg = _PCfg(VideoMeta(width=w, height=h, subsamp=subsamp),
                 blk_w, blk_h, False, lossless, do_psy)

    def run(lanes):
        xs, bd, q, fq, fthresh, do_filter = zip(*lanes)
        xs = [_cat([x[c] for x in xs]) for c in range(3)]
        bd, q = _cat(bd), _cat(q)
        lls, vs, recons = encode_planes(pcfg, xs, bd, q, True)
        buf, smalls = _finish_blob(lls, vs, pcfg)
        vis = _visible(pcfg, recons)
        if not lossless:
            sc = _upload_ints((fq, fthresh, do_filter), bd.device)
            vis[0] = filters.intra_filter_graph(
                pcfg.pdims[0][0], pcfg.pdims[0][1], pcfg.nbh, pcfg.nbv,
                vis[0], bd, sc[0], sc[1] * sc[2])
        return _encode_lanes(buf, smalls, vs,
                             _chain_outputs(pcfg, levels, vis), len(lanes))

    return run


@functools.lru_cache(maxsize=None)
def make_p_chain_lanes(cfg):
    """P encode step + device reference chain of the lanes of a flush,
    cfg (w, h, subsamp, blk_w, blk_h, lossless, do_psy, levels,
    inter_sharpen): recon -> in-loop luma and chroma filters -> border
    extension -> pyramid. Lanes are (srcs_full, refs, ints): the bordered
    input planes, whose MC canvas slice (the apron rows/cols past the
    visible edge included) the step codes, the bordered reference planes
    of whatever flush made them, and the uploaded p_chain_ints. The P
    encode chain runs over (L, ...) stacks, the blob is one vk launch per
    plane, the filters one luma and one chroma (U and V of every lane)
    launch. Only the key and the number of lanes steer its Python, so one
    CUDA graph of a flush of L lanes serves every such flush of the key
    (dynbatch.flush_step). Returns a LaneOut per lane (ref:
    dsv_encoder.c:1123-1172 + bmc.c:459-659)."""
    w, h, subsamp, blk_w, blk_h, lossless, do_psy, levels, inter_sharpen = cfg
    pcfg = _PCfg(VideoMeta(width=w, height=h, subsamp=subsamp),
                 blk_w, blk_h, True, lossless, do_psy)
    B = framedev.B
    n = 8 * pcfg.nbv * pcfg.nbh

    def run(lanes):
        srcs_full, refs, ints = zip(*lanes)
        srcs = [_stack([s[c][B:B + pcfg.mc_cfg(c).gh,
                             B:B + pcfg.mc_cfg(c).gw] for s in srcs_full])
                for c in range(3)]
        refs = [_stack([r[c] for r in refs]) for c in range(3)]
        ints = _stack(ints)
        g = ints[:, :n].view(len(lanes), 8, pcfg.nbv, pcfg.nbh)
        mvx, mvy, flags, submask, dc = g[:, :5].unbind(1)
        bd, eprm_m, mlt_m = g[:, 5].to(torch.uint8), g[:, 6] != 0, g[:, 7] != 0
        q, tmc, fq, fthresh, do_filter = ints[:, n:].unbind(1)
        recons, lls, vs = _p_encode(pcfg, srcs, refs, mvx, mvy, flags,
                                    submask, dc, bd, eprm_m, mlt_m, q, tmc)
        buf, smalls = _finish_blob(lls, vs, pcfg)
        vis = _p_filters(pcfg, inter_sharpen, _visible(pcfg, recons), mvx,
                         mvy, flags, submask, q, tmc, fq, fthresh, do_filter)
        return _encode_lanes(buf, smalls, vs,
                             _chain_outputs(pcfg, levels, vis), len(lanes))

    return run


def fetch_sparse_outs(step_out):
    """Host fetch of a one-frame step's outputs, or of one lane's
    (LaneOut): the metadata, then the occupied blob bytes of the frame's
    (lane's) planes. Returns (vscans, lls) per plane, each vscan ("blob",
    bytes of the device blob) or, on the per-plane contract fallback,
    ("dense", the int32 scan array)."""
    buf, smalls, vs = step_out[:3]
    lane = step_out[4] if len(step_out) > 4 else 0
    sm = xfer.host(smalls).reshape(3, 4, -1)
    useds = sm[:, 2, :].astype(np.int64)             # (plane, frame)
    if useds.shape[1] == 1:   # one frame: the occupied prefix
        offs = np.cumsum(useds[:, 0]) - useds[:, 0]
        packed = xfer.slice_packed(buf, int(useds.sum()))
    else:   # a lane of a flush: its three ranges, gathered on the device
        offs = (np.cumsum(useds) - useds.reshape(-1)).reshape(useds.shape)
        packed = torch.cat([buf[int(o):int(o + u)] for o, u in
                            zip(offs[:, lane], useds[:, lane])])
        offs = np.cumsum(useds[:, lane]) - useds[:, lane]
    packed = xfer.host(packed)   # one copy
    vscans, lls = [], []
    for c in range(3):
        _, ll, used, fb = (int(x) for x in sm[c, :, lane])
        if fb:
            vscans.append(("dense", xfer.host(vs[c][0])))
        else:
            vscans.append(("blob", packed[offs[c]:offs[c] + used]))
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


def _decode_pixels(pcfg, vs, bd, q, lls, arena=None):
    """Per plane: dequantize + inverse SBT -> clamped pixels uint8[...,
    ch, cw]. vs[c] int32[..., total], bd uint8[..., nbv, nbh], q int32[...],
    lls int32[..., 3]. With an arena (one frame; int32 (3 * w_luma,)),
    each plane's inverse reads its stale scratch row from the arena and
    leaves its level-1 scratch there, in place."""
    outs = []
    for c in range(3):
        scfg = pcfg.sbt_cfg(c)
        coefs = hzcc.make_dequantize(pcfg.hzcc_cfg(c))(vs[c], bd, q,
                                                       lls[..., c])
        if arena is None:
            px = sbt.make_inv_sbt(scfg)(coefs, bd, q)
        else:
            stale = arena[2 * scfg.cw:3 * scfg.cw].clone()
            px, tmp = sbt.make_inv_sbt_arena(scfg)(coefs, bd, q, stale)
            _arena_apply(arena, tmp, scfg.cw)
        outs.append(_clip_u8(px))
    return outs


def _arena_apply(arena, tmp, wp):
    """Overlay one plane's level-1 scratch rows tmp (ph, pw) onto the flat
    arena, in place: flat[wp * (1 + r) + j] per the reference's
    temp_buf_pad layout (sbt.c:858-860); only the first 3 * w_luma
    entries are ever read back."""
    n = int(arena.shape[0])
    ph = int(tmp.shape[0])
    r = 0
    while wp * (1 + r) < n and r < ph:
        a = wp * (1 + r)
        ln = min(wp, n - a)
        arena[a:a + ln] = tmp[r, :ln]
        r += 1


@functools.lru_cache(maxsize=None)
def make_i_decode_step(w, h, subsamp, blk_w, blk_h, lossless):
    """step(vs, bd, q, lls, arena=None) -> the three planes' pixels
    uint8[..., ch, cw] (dequantize + inverse SBT; leading frame
    dimensions ride along). An arena (one frame) is threaded in place:
    each plane's inverse reads the stale scratch row 1 at its flat offset
    and leaves its level-1 scratch behind for later planes and frames
    (reachable only at extreme aspect ratios; see ops/sbt.degenerate)."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)
    return functools.partial(_decode_pixels, pcfg)


@functools.lru_cache(maxsize=None)
def make_p_decode_step(w, h, subsamp, blk_w, blk_h, lossless):
    """Dequant + inverse SBT + MC prediction + reconstruction of one frame
    (ref: dsv_decoder.c:512-549). step(vs, bd, q, lls, refs, mvx, mvy,
    flags, submask, dc, tmc, bad=(), arena=None) -> per plane the
    reconstructed canvas uint8 (gh, gw); refs are the bordered reference
    planes. Leading (lane) dimensions ride along (without an arena). A
    plane in `bad` reconstructs against an all-zero residual (the
    reference skips its inverse transform); the arena as for
    make_i_decode_step (P planes never read the stale scratch, inter
    chroma being Haar, but their inverses keep writing it, and later
    intra frames read what they left)."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, True, lossless)

    def step(vs, bd, q, lls, refs, mvx, mvy, flags, submask, dc, tmc,
             bad=(), arena=None):
        pxs = _decode_pixels(pcfg, vs, bd, q, lls, arena)
        outs = []
        for c in range(3):
            mcc = pcfg.mc_cfg(c)
            pw, ph = pcfg.pdims[c]
            res = torch.zeros(bd.shape[:-2] + (mcc.gh, mcc.gw),
                              dtype=torch.uint8, device=pxs[c].device)
            if c not in bad:
                res[..., :ph, :pw] = pxs[c][..., :ph, :pw]
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


def scan_upload(pcfg, vs, lossless):
    """(vectors, dense): what the decoder's device chain uploads for one
    picture's scans. compact_vs's form where it has one; the dense int32
    vectors (dense True) for a lossless picture or where compact_vs gives
    None, a plane with more than _NFIX HF values outside int8 (high
    quality streams at the CLI's default CRF or -qp >= 85)."""
    cvs = compact_vs(pcfg, vs, lossless)
    if cvs is None or lossless:
        return tuple(np.asarray(v, np.int32) for v in vs), True
    return cvs, False


def _expand_vs(vs, dense):
    """Device side of compact_vs: sign-extend the int8 tail and patch the
    fixups, over leading frame dimensions; dense vectors (scan_upload)
    pass through. The twin's scatter drops the out-of-range positions
    (mode="drop"); torch has no such mode, so they are sent to one
    scratch slot past the tail, cut off afterwards."""
    if dense:
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


def _id_visible(pcfg, lossless, dense, vs, bd, q, lls, fq, fthresh,
                do_filter, bad=(), arena=None):
    """Intra decode + intra dering filter -> visible planes (shared body
    of the single-frame chain step and the K-frame step); the planes in
    `bad` are zero before the filter."""
    meta = pcfg.meta
    base = make_i_decode_step(meta.width, meta.height, meta.subsamp,
                              pcfg.blk_w, pcfg.blk_h, lossless)
    vis = _visible(pcfg, base(_expand_vs(vs, dense), bd, q, lls, arena))
    for c in bad:
        vis[c] = torch.zeros_like(vis[c])
    if not lossless:
        vis[0] = filters.intra_filter_graph(
            pcfg.pdims[0][0], pcfg.pdims[0][1], pcfg.nbh, pcfg.nbv, vis[0],
            bd, fq, fthresh * do_filter)
    return vis


@functools.lru_cache(maxsize=None)
def make_id_chain_step(w, h, subsamp, blk_w, blk_h, lossless, dense):
    """Intra decode + device reference chain: recon -> intra dering filter
    -> border extension. step(vs, bd, q, lls, fq, fthresh, do_filter,
    bad=(), arena=None) -> (packed visible payload uint8, {"recon":
    bordered planes}) (ref: dsv_decoder.c:512-549 + bmc.c:390-457); vs in
    scan_upload's form, dense vectors if `dense`; the corrupt planes
    `bad` and the arena as for make_i_decode_step / _id_visible."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)

    def step(vs, bd, q, lls, fq, fthresh, do_filter, bad=(), arena=None):
        vis = _id_visible(pcfg, lossless, dense, vs, bd, q, lls, fq,
                          fthresh, do_filter, bad, arena)
        return _packed(vis), _chain(pcfg, vis)

    return step


@functools.lru_cache(maxsize=None)
def make_pd_chain_step(w, h, subsamp, blk_w, blk_h, lossless,
                       inter_sharpen, dense):
    """P decode + device reference chain: recon -> in-loop luma/chroma
    filters -> border extension, one frame; refs are the previous frame's
    chain planes (ref: dsv_decoder.c:512-549 + bmc.c:459-659); vs in
    scan_upload's form, dense vectors if `dense`; the corrupt planes `bad`
    and the arena as for make_p_decode_step."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, True, lossless)
    base = make_p_decode_step(w, h, subsamp, blk_w, blk_h, lossless)

    def step(vs, bd, q, lls, refs, mvx, mvy, flags, submask, dc, tmc,
             fq, fthresh, do_filter, bad=(), arena=None):
        vis = _visible(pcfg, base(_expand_vs(vs, dense), bd, q, lls,
                                  refs, mvx, mvy, flags, submask, dc, tmc,
                                  bad, arena))
        vis = _p_filters(pcfg, inter_sharpen, vis, mvx, mvy, flags, submask,
                         q, tmc, fq, fthresh, do_filter)
        return _packed(vis), _chain(pcfg, vis)

    return step


@functools.lru_cache(maxsize=None)
def make_pd_chain_multi(w, h, subsamp, blk_w, blk_h, lossless,
                        inter_sharpen, dense):
    """K-frame P decode: the single-frame chain step over stacked per-frame
    inputs (leading dimension K), the reference threaded from frame to
    frame on the device. Returns ((K, npix) payload, {"recon": the last
    frame's chain})."""
    single = make_pd_chain_step(w, h, subsamp, blk_w, blk_h, lossless,
                                inter_sharpen, dense)

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
def make_id_chain_multi(w, h, subsamp, blk_w, blk_h, lossless, dense):
    """K-frame intra decode of independent (non-ref) frames: the leading
    dimension K is the batch of every op, the intra filter runs the K
    luma planes in one wavefront, and the reference chain is not built
    (non-ref frames never need it). Returns the (K, npix) payload."""
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)

    def step(vs, bd, q, lls, fq, fthresh, do_filter):
        return _packed(_id_visible(pcfg, lossless, dense, vs, bd, q, lls,
                                   fq, fthresh, do_filter))

    return step


def _stack_up(vals, device):
    """Per-lane host arrays (or tuples of them: the compact scan form) ->
    one array per field with a leading lane dimension, uploaded once."""
    if isinstance(vals[0], tuple):
        return tuple(_stack_up(v, device) for v in zip(*vals))
    return xfer.upload(np.ascontiguousarray(np.stack(vals)), device)


def _up_lane(args, device):
    """One lane's host arguments on the device, as the one-frame steps
    take them (ints and 0-d values become 0-d int32 tensors)."""
    if isinstance(args, tuple):
        return tuple(_up_lane(a, device) for a in args)
    if isinstance(args, torch.Tensor) or args is None:
        return args
    return xfer.upload(np.ascontiguousarray(np.asarray(
        args, np.int32 if isinstance(args, int) else None)), device)


def _decode_one_by_one(step, lanes, device):
    """Lanes whose one-frame step cannot batch (each threads its own arena
    in place): the step once per lane, host arguments uploaded per lane;
    the last two arguments (bad, arena) pass as they are."""
    return [step(*_up_lane(tuple(a[:-2]), device), *a[-2:]) for a in lanes]


@functools.lru_cache(maxsize=None)
def make_id_chain_lanes(cfg):
    """make_id_chain_step over the lanes of a flush, cfg (w, h, subsamp,
    blk_w, blk_h, lossless, dense, bad, arena, device). Lanes are its
    argument tuples (vs, bd, q, lls, fq, fthresh, do_filter, bad, arena),
    host arrays and ints standing in for tensors; the lanes share the
    scan form (`dense`) and the corrupt planes (`bad`). The decode runs over
    (L, ...) stacks uploaded once per field, one intra filter launch for
    every lane. Returns (packed payload, {"recon": bordered planes}) per
    lane, views of the flush's. With the arena (degenerate geometries)
    the lanes run one after another, each on its own arena."""
    w, h, subsamp, blk_w, blk_h, lossless, dense, bad, arena, device = cfg
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, False, lossless)
    dev = torch.device(device)
    if arena:
        step = make_id_chain_step(w, h, subsamp, blk_w, blk_h, lossless,
                                  dense)
        return lambda lanes: _decode_one_by_one(step, lanes, dev)

    def run(lanes):
        vs, bd, q, lls, fq, fthresh, do_filter = list(zip(*lanes))[:7]
        sc = _upload_ints((q, fq, fthresh, do_filter), dev)
        vis = _id_visible(pcfg, lossless, dense, _stack_up(vs, dev),
                          _stack_up(bd, dev), sc[0], _stack_up(lls, dev),
                          sc[1], sc[2], sc[3], bad)
        packed, chain = _packed(vis), _chain(pcfg, vis)
        return [(packed[i], _lane_views(chain, i))
                for i in range(len(lanes))]

    return run


@functools.lru_cache(maxsize=None)
def make_pd_chain_lanes(cfg):
    """make_pd_chain_step over the lanes of a flush, cfg (w, h, subsamp,
    blk_w, blk_h, lossless, inter_sharpen, dense, bad, arena, device).
    Lanes are its argument tuples (vs, bd, q, lls, refs, mvx, mvy, flags,
    submask, dc, tmc, fq, fthresh, do_filter, bad, arena), host arrays
    and ints standing in for tensors, refs each lane's device reference
    planes (stacked per flush: whatever flush made them). The decode and
    MC run over (L, ...) stacks, one luma and one chroma (U and V of every
    lane) filter launch.
    Returns (packed payload, {"recon": bordered planes}) per lane; with
    the arena the lanes run one after another, as make_id_chain_lanes."""
    (w, h, subsamp, blk_w, blk_h, lossless, inter_sharpen, dense, bad, arena,
     device) = cfg
    pcfg = _pcfg(w, h, subsamp, blk_w, blk_h, True, lossless)
    dev = torch.device(device)
    if arena:
        step = make_pd_chain_step(w, h, subsamp, blk_w, blk_h, lossless,
                                  inter_sharpen, dense)
        return lambda lanes: _decode_one_by_one(step, lanes, dev)
    base = make_p_decode_step(w, h, subsamp, blk_w, blk_h, lossless)

    def run(lanes):
        a = list(zip(*lanes))
        refs = [_stack([r[c] for r in a[4]]) for c in range(3)]
        mvx, mvy, flags, submask, dc = xfer.upload(
            np.stack([np.stack(g) for g in a[5:10]]), dev)
        q, tmc, fq, fthresh, do_filter = _upload_ints(
            (a[2], a[10], a[11], a[12], a[13]), dev)
        vis = _visible(pcfg, base(
            _expand_vs(_stack_up(a[0], dev), dense), _stack_up(a[1], dev), q,
            _stack_up(a[3], dev), refs, mvx, mvy, flags, submask, dc, tmc,
            bad))
        vis = _p_filters(pcfg, inter_sharpen, vis, mvx, mvy, flags, submask,
                         q, tmc, fq, fthresh, do_filter)
        packed, chain = _packed(vis), _chain(pcfg, vis)
        return [(packed[i], _lane_views(chain, i))
                for i in range(len(lanes))]

    return run

