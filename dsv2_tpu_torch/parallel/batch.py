"""Batched intra encoding: one device pass for many frames.

Port of `dsv2_tpu/parallel/batch.py` (blob transfer). For CRF/CQP
intra-only encoding the per-frame quant sequence is independent of the
coded output (rate control feeds back rc_qual, not bytes; ref:
dsv_encoder.c:1552-1570), so the device work — HVS block analysis,
forward SBT, adaptive quantization and the entropy-coded scan blob — runs
over a chunk of frames at once (leading frame dimension), and the host
then frames the blobs into packets in one native call. Produces
byte-identical streams to the sequential encoder.

Pipelining: torch launches are asynchronous on the current CUDA stream
and nothing in the device step reads a value back, so the host prepares
chunk k+1 while the card computes chunk k. Uploads go through pinned
memory; each chunk's metadata and blob prefix come back with
non-blocking copies into pinned buffers, each behind its own CUDA event.
"""
import functools

import numpy as np
import torch

from .. import native
from ..bitstream import BitWriter
from ..codec import devsteps, motion, rc
from ..codec import plane as planecode
from ..codec.decoder import _PCfg
from ..codec.encoder import EncData
from ..codec.motion import MotionField
from ..core import constants as K
from ..core import intmath as im
from ..core.frame import B, Frame, ds2x_luma
from ..ops import blockanalysis, hzcc
from ..ops.blockanalysis import intra_analysis
from ..utils import log, packet
from ..utils.packet import VideoMeta
from ..utils.trace import count as _count
from ..utils.trace import stage as _stage
from . import xfer


@functools.lru_cache(maxsize=None)
def _device_batch_fn(w_, h_, subsamp, blk_w, blk_h, lossless, do_psy,
                     analyze=False):
    """fn(xs0, xs1, xs2, bds, qs) -> (buf, smalls, vs, (fl, bd)) for a
    chunk of nfr frames: xs* (nfr, ch, cw) uint8 planes, bds (nfr, nbv,
    nbh) uint8, qs (nfr,) int32. buf/smalls as devsteps._finish_blob; vs
    the per-plane int32 scans (the fallback payload). With analyze, bds
    carries only the host temporal-stability part and the HVS analysis
    runs here; fl packs its flags ring | maint<<1 | keep<<2."""
    pcfg = _PCfg(VideoMeta(width=w_, height=h_, subsamp=subsamp),
                 blk_w, blk_h, False, lossless, do_psy)
    flags_fn = blockanalysis.device_intra_flags(pcfg) if analyze else None

    def batch(xs0, xs1, xs2, bds, qs):
        if analyze:
            # blockdata is derived exactly as _stable_decisions would
            # (ref: hme.c:1835-1971, dsv_encoder.c:797-883)
            ring, maint, keep = flags_fn(xs0, xs1, xs2)
            u8 = torch.uint8
            stable = (bds != 0) | keep
            bd = ((stable.to(u8) << K.STABLE_BIT)
                  | (ring.to(u8) << K.RINGING_BIT)
                  | (maint.to(u8) << K.MAINTAIN_BIT))
            fl = ring.to(u8) | (maint.to(u8) << 1) | (keep.to(u8) << 2)
        else:
            bd = bds
            fl = torch.zeros_like(bds)
        lls, vs = devsteps.encode_planes(pcfg, (xs0, xs1, xs2), bd, qs)
        buf, smalls = devsteps._finish_blob(lls, vs, pcfg)
        return buf, smalls, vs, (fl, bd)

    return batch


def encode_intra_batch(enc, frame_planes, chunk=16):
    """Encode a list of (y, u, v) frames, every one intra, in chunked
    device batches on enc.device, overlapping each chunk's host
    serialization with the next chunk's device compute. Returns the
    packet byte chunks: at gop=0 the same as sequential encode_frame
    calls, byte-for-byte; at any other gop `dsv2_tpu`'s
    encode_intra_batch stream, a metadata packet at each GOP start
    (`enc.gop` frames apart) before an intra picture. No reconstruction
    is built: no frame of the batch is a reference."""
    out = []
    pending = None
    for lo in range(0, len(frame_planes), chunk):
        with _stage("batch.prep"):
            ctx = _prep_chunk(enc, frame_planes[lo:lo + chunk])
        if pending is not None:
            # start the previous chunk's d2h copies BEFORE enqueueing this
            # chunk's compute: the stream runs in order, so a fetch issued
            # after dispatch would wait behind the next chunk
            with _stage("batch.fetch"):
                _start_fetch(enc, pending)
        with _stage("batch.dispatch"):
            _dispatch_chunk(enc, ctx)
        if pending is not None:
            with _stage("batch.serialize"):
                out.extend(_serialize_chunk(enc, pending))
        pending = ctx
    if pending is not None:
        with _stage("batch.fetch"):
            _start_fetch(enc, pending)
        with _stage("batch.serialize"):
            out.extend(_serialize_chunk(enc, pending))
    return out


def _prep_chunk(enc, frame_planes):
    """Host-side per-frame prep: padding, params, rate control, stable
    decisions, header stats."""
    meta = enc.meta

    # The border apron is only read by odd-dimension pyramid downsampling
    # here; when every pyramid level stays even (ds2x reads no border
    # then, frame.py:136), the per-frame extend() calls are dead work.
    need_borders = False
    w_, h_ = meta.width, meta.height
    for _ in range(K.MAX_PYRAMID_LEVELS + 1):
        if w_ % 2 or h_ % 2:
            need_borders = True
            break
        w_, h_ = im.round_shift(w_, 1), im.round_shift(h_, 1)

    def _pyr(padded):
        if need_borders:
            return enc._mk_pyramid(padded)
        pyr = []
        prev = padded
        w2, h2 = padded.width, padded.height
        for i in range(enc.pyramid_levels):
            f = Frame(padded.subsamp, im.round_shift(w2, i + 1),
                      im.round_shift(h2, i + 1), border=True)
            ds2x_luma(f, prev)
            pyr.append(f)
            prev = f
        return pyr

    datas = []
    for planes in frame_planes:
        padded = Frame(meta.subsamp, meta.width, meta.height, border=True)
        padded.load(planes)
        if need_borders:
            padded.extend()
        d = EncData(enc.next_fnum, padded)
        enc.next_fnum += 1
        enc._setup_params(d)
        d.params.is_ref = 0
        d.params.has_ref = 0
        # no motion search in an intra batch: build the pyramid lazily
        # (only CRF dark-intra-boost rate control ever reads it)
        d._pyramid_fn = (lambda padded=padded: _pyr(padded))
        datas.append(d)

    p = datas[0].params
    pcfg = _PCfg(meta, p.blk_w, p.blk_h, False, p.lossless, p.do_psy)
    nblk = p.nbh * p.nbv
    analyze = blockanalysis.device_analysis_ok(pcfg)
    gop_starts, rc_quals, quants, intramvs = [], [], [], []
    blockdatas, stable_bits_all, stats_all = [], [], []
    for d in datas:
        gop_start = 0
        if enc.force_metadata or (enc.prev_gop + enc.gop) <= d.fnum:
            gop_start = 1
            enc.prev_gop = d.fnum
            enc.force_metadata = 0
        gop_starts.append(gop_start)
        if enc.intra_map is None:
            enc.intra_map = np.zeros(nblk, dtype=np.uint8)
        enc.intra_map[:] = 0
        d.quant = rc.quality2quant(enc, d, enc.prev_gop, 0)
        enc._compute_auto_filter(d)
        quants.append(d.quant)
        if analyze:
            # HVS analysis runs on the device; prep provides only the host
            # temporal-stability part (in intra-only batches the stability
            # accumulators never move, so this is state-safe under chunk
            # pipelining)
            if enc.refresh_ctr >= enc.stable_refresh:
                enc.refresh_ctr = 0
                enc.stability[:] = 0
            avgdiv = max(enc.refresh_ctr, 1)
            if d.fnum > 0 and enc.do_temporal_aq:
                hs_part = ((enc.stability[:, 0] // avgdiv == 0)
                           & (enc.stability[:, 1] // avgdiv == 0))
            else:
                hs_part = np.zeros(nblk, dtype=bool)
            intramvs.append(None)
            stats_all.append(None)
            stable_bits_all.append(hs_part)
            blockdatas.append(
                hs_part.reshape(p.nbv, p.nbh).astype(np.uint8))
        else:
            intramv = intra_analysis(d.padded, d.params)
            intramvs.append(intramv)
            stats = [K.ONE_MARKER] * K.MAX_STAT
            if enc.effort >= 7:
                enc._gather_stats(d, intramv, stats)
                stats = [(K.ZERO_MARKER if s > 0 else K.ONE_MARKER)
                         for s in stats]
            else:
                stats[K.MAINTAIN_STAT] = K.ZERO_MARKER
                stats[K.RINGING_STAT] = K.ZERO_MARKER
            stats_all.append(stats)
            stable_bits = enc._stable_decisions(d, intramv)
            stable_bits_all.append(stable_bits)
            fl = intramv.flags
            enc.blockdata |= (((fl >> K.MV_BIT_RINGING) & 1) << K.RINGING_BIT
                              ).astype(np.uint8)
            enc.blockdata |= (((fl >> K.MV_BIT_MAINTAIN) & 1)
                              << K.MAINTAIN_BIT).astype(np.uint8)
            blockdatas.append(enc.blockdata.reshape(p.nbv, p.nbh).copy())
        rc_quals.append(enc.rc_qual)
        # per-frame RC stats (CRF/CQP only; size-independent)
        if enc.rc_mode == K.RC_CRF:
            enc.rf_total += enc.rc_qual
            enc.rf_reset += 1
            enc.rf_avg = enc.rf_total // enc.rf_reset
            if enc.rf_reset >= K.RF_RESET:
                enc.rf_total = enc.rf_avg
                enc.total_P_frame_q = enc.total_P_frame_q // enc.rf_reset
                enc.rf_reset = 1

    return dict(datas=datas, pcfg=pcfg, p=p, gop_starts=gop_starts,
                rc_quals=rc_quals, quants=quants, intramvs=intramvs,
                blockdatas=blockdatas, stable_bits_all=stable_bits_all,
                stats_all=stats_all, analyze=analyze)


def _chunk_inputs(enc, ctx):
    """The chunk's device inputs, uploaded without blocking: the three
    (nfr, ch, cw) uint8 coefficient-dim planes, blockdata and quants."""
    datas, pcfg = ctx["datas"], ctx["pcfg"]
    dev = enc.device
    xs = []
    for c in range(3):
        cw, ch = pcfg.cdims[c]
        pw, ph = pcfg.pdims[c]
        x = np.full((len(datas), ch, cw), 128, dtype=np.uint8)
        for fi, d in enumerate(datas):
            x[fi, :ph, :] = d.padded.planes[c][B:B + ph, B:B + cw]
        xs.append(xfer.upload(x, dev))
    bds = xfer.upload(np.stack(ctx["blockdatas"]), dev)
    qs = xfer.upload(np.asarray(ctx["quants"], dtype=np.int32), dev)
    return xs, bds, qs


def _dispatch_chunk(enc, ctx):
    """Upload + one asynchronous device pass for the chunk; starts the
    metadata (and analysis flags) d2h copies right behind it, so the
    caller's serialization of the previous chunk overlaps the compute."""
    meta, p = enc.meta, ctx["p"]
    xs, bds, qs = _chunk_inputs(enc, ctx)
    fn = _device_batch_fn(meta.width, meta.height, meta.subsamp,
                          p.blk_w, p.blk_h, p.lossless, p.do_psy,
                          ctx["analyze"])
    buf, smalls, vs, (fl, _) = fn(xs[0], xs[1], xs[2], bds, qs)
    ctx["dev"] = dict(buf=buf, vs=vs, smalls=xfer.start_d2h(smalls),
                      fl=xfer.start_d2h(fl) if ctx["analyze"] else None)


def _start_fetch(enc, ctx):
    """Enqueue the blob payload's d2h copy without waiting for it (so the
    next chunk's dispatch overlaps this chunk's transfer). Reads the
    metadata, which waits for this chunk's compute to finish."""
    dv = ctx["dev"]
    nfr = len(ctx["datas"])
    sm = xfer.finish_d2h(dv["smalls"]).reshape(3, 4, nfr)
    ns, lls, useds, fbs = (list(sm[:, i]) for i in range(4))
    used_flat = sm[:, 2].reshape(-1).astype(np.int64)
    packed = xfer.start_d2h(xfer.slice_packed(dv["buf"],
                                              int(used_flat.sum())))
    ctx["fetch"] = (ns, lls, used_flat, fbs, packed)


def _serialize_chunk(enc, ctx):
    """Blocking fetches + host serialization for a dispatched chunk."""
    meta = enc.meta
    datas, pcfg, p = ctx["datas"], ctx["pcfg"], ctx["p"]
    nfr = len(datas)
    dv = ctx["dev"]
    (gop_starts, rc_quals, intramvs, blockdatas, stable_bits_all,
     stats_all) = (ctx["gop_starts"], ctx["rc_quals"], ctx["intramvs"],
                   ctx["blockdatas"], ctx["stable_bits_all"],
                   ctx["stats_all"])
    if ctx["analyze"]:
        fls = xfer.finish_d2h(dv["fl"])  # (nfr, nbv, nbh)
        for fi, d in enumerate(datas):
            flr = fls[fi].reshape(-1)
            ring = (flr & 1).astype(np.uint32)
            maint = ((flr >> 1) & 1).astype(np.uint32)
            keep = ((flr >> 2) & 1).astype(np.uint32)
            imv = MotionField(p.nbh, p.nbv)
            imv.flags = ((ring << K.MV_BIT_RINGING)
                         | (maint << K.MV_BIT_MAINTAIN)
                         | (keep << K.MV_BIT_SKIP))
            intramvs[fi] = imv
            stats = [K.ONE_MARKER] * K.MAX_STAT
            if enc.effort >= 7:
                enc._gather_stats(d, imv, stats)
                stats = [(K.ZERO_MARKER if st > 0 else K.ONE_MARKER)
                         for st in stats]
            else:
                stats[K.MAINTAIN_STAT] = K.ZERO_MARKER
                stats[K.RINGING_STAT] = K.ZERO_MARKER
            stats_all[fi] = stats
            stable = stable_bits_all[fi] | keep.astype(bool)
            stable_bits_all[fi] = stable.astype(np.uint8)
            enc.blockdata[:] = ((stable.astype(np.uint8) << K.STABLE_BIT)
                                | (ring << K.RINGING_BIT).astype(np.uint8)
                                | (maint << K.MAINTAIN_BIT).astype(np.uint8))
            blockdatas[fi] = enc.blockdata.reshape(p.nbv, p.nbh).copy()
    ns, lls, used_flat, fbs, packed_h = ctx["fetch"]
    offs_flat = np.concatenate([[0], np.cumsum(used_flat)[:-1]])
    packed = xfer.finish_d2h(packed_h)

    if (not any(int(fbs[c][fi]) for c in range(3) for fi in range(nfr))
            and log.get_level() < log.LEVEL_INFO):
        # fast path: the native runtime assembles every complete packet in
        # one call straight from the device blobs (framing is a memcpy)
        return _serialize_chunk_native(enc, ctx, packed, offs_flat,
                                       used_flat, ns, lls)

    # per (plane, frame): the device blob, or the int32 scan on the
    # per-plane contract fallback (the host re-encodes it natively)
    vscans = []
    for c in range(3):
        col = []
        for fi in range(nfr):
            if fbs[c][fi]:
                enc.stats.blob_fallbacks += 1
                _count("blob.fallback")
                with _stage("batch.fallback.fetch"):
                    col.append(("dense", xfer.host(dv["vs"][c][fi])))
            else:
                o = int(offs_flat[c * nfr + fi])
                u = int(used_flat[c * nfr + fi])
                col.append(("blob", packed[o:o + u]))
        vscans.append(col)

    # --- host: serialize ----------------------------------------------------
    chunks = []
    for fi, d in enumerate(datas):
        w = BitWriter(1 << 16)
        packet.write_packet_hdr(w, K.make_pt(0, 0))
        w.align()
        w.put_bits(32, d.fnum)
        stats = stats_all[fi]
        w.align()
        w.put_ueg(im.lb2(p.blk_w) - 4)
        w.put_ueg(im.lb2(p.blk_h) - 4)
        w.align()
        w.put_bit(stats[K.STABLE_STAT])
        w.put_bit(stats[K.MAINTAIN_STAT])
        w.put_bit(stats[K.RINGING_STAT])
        w.put_bit(enc.do_intra_filter)
        w.put_bits(K.MAX_QP_BITS, d.quant)
        w.put_bit(0)
        w.align()
        motion.encode_stable_blocks(w, stable_bits_all[fi], stats)
        imv = intramvs[fi]
        ring_bits = (imv.flags & (1 << K.MV_BIT_RINGING)) != 0
        maint_bits = (imv.flags & (1 << K.MV_BIT_MAINTAIN)) != 0
        motion.encode_intra_meta(w, ring_bits, maint_bits, stats)
        w.align()
        for c in range(3):
            cw, ch = pcfg.cdims[c]
            kind, payload = vscans[c][fi]
            if kind == "blob":
                planecode.encode_plane_blob(w, payload, int(lls[c][fi]))
            else:
                with _stage("batch.fallback.code"):
                    planecode.encode_plane(w, payload, int(lls[c][fi]),
                                           cw, ch)
        out = w.data()
        bufs = []
        if gop_starts[fi]:
            mbuf = bytearray(packet.encode_metadata(meta))
            bufs.append(enc._link(mbuf))
        bufs.append(enc._link(bytearray(out)))
        enc._tally_intra_size(len(out), rc_quals[fi])
        chunks.extend(bytes(b) for b in bufs)
    return chunks


def _serialize_chunk_native(enc, ctx, packed, offs_flat, used_flat, ns, lls):
    """Whole-packet assembly in the native runtime: one C call produces
    every complete intra packet of the chunk straight from the
    device-built scan blobs (framing is a memcpy)."""
    meta = enc.meta
    datas, pcfg, p = ctx["datas"], ctx["pcfg"], ctx["p"]
    nfr = len(datas)
    (gop_starts, rc_quals, intramvs, stable_bits_all, stats_all) = (
        ctx["gop_starts"], ctx["rc_quals"], ctx["intramvs"],
        ctx["stable_bits_all"], ctx["stats_all"])
    nblk = p.nbh * p.nbv
    statbits = np.zeros((nfr, 3), dtype=np.uint8)
    stable = np.zeros((nfr, nblk), dtype=np.uint8)
    ring = np.zeros((nfr, nblk), dtype=np.uint8)
    maint = np.zeros((nfr, nblk), dtype=np.uint8)
    fnums = np.zeros(nfr, dtype=np.uint32)
    for fi, d in enumerate(datas):
        statbits[fi] = stats_all[fi][:3]
        stable[fi] = np.asarray(stable_bits_all[fi], dtype=np.uint8) & 1
        fl = intramvs[fi].flags
        ring[fi] = ((fl >> K.MV_BIT_RINGING) & 1).astype(np.uint8)
        maint[fi] = ((fl >> K.MV_BIT_MAINTAIN) & 1).astype(np.uint8)
        fnums[fi] = d.fnum
    segments3 = [hzcc.scan_segments(*pcfg.cdims[c]) for c in range(3)]
    lls_arr = np.concatenate([np.asarray(lls[c], dtype=np.int32)
                              for c in range(3)])
    hdr6 = K.FOURCC + bytes([K.VERSION_MINOR, K.make_pt(0, 0)])
    pkts = native.intra_packets(
        hdr6, fnums, np.asarray(ctx["quants"], dtype=np.int32),
        im.lb2(p.blk_w) - 4, im.lb2(p.blk_h) - 4, K.MAX_QP_BITS,
        statbits, enc.do_intra_filter, stable, ring, maint,
        packed, offs_flat, used_flat, lls_arr, segments3,
        planecode.EOP_SYMBOL, int(np.concatenate(ns).sum()), blob=True)
    chunks = []
    for fi, d in enumerate(datas):
        bufs = []
        if gop_starts[fi]:
            mbuf = bytearray(packet.encode_metadata(meta))
            bufs.append(enc._link(mbuf))
        bufs.append(enc._link(bytearray(pkts[fi])))
        enc._tally_intra_size(len(pkts[fi]), rc_quals[fi])
        chunks.extend(bytes(b) for b in bufs)
    return chunks
