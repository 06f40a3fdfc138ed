"""Whole-frame intra device steps.

Port of the intra, blob-transfer part of `dsv2_tpu/codec/devsteps.py`:
the per-plane forward SBT -> quantize -> scan blob chain, the blob merge
(`_finish_blob`), the single-frame step of the sequential session
(`make_i_encode_step`, reconstruction-free: gop=0 keeps no reference)
and its host fetch (`fetch_sparse_outs`). Every function takes a leading
frame dimension; the sequential step is the batch of one. The batched
pipeline (parallel/batch.py) runs the same `encode_planes`.
"""
import functools

import numpy as np
import torch

from dsv2_tpu.utils.packet import VideoMeta

from ..ops import hzcc, scan_pl, sbt
from ..parallel import xfer
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
