"""DSV2 v2.8 decoder session on the device chain.

Port of `dsv2_tpu/codec/decoder.py` (ref: src/dsv_decoder.c). Host side:
packet/header parsing, block metadata and motion deserialization, the
native entropy scan, and the scan upload (compact, or the dense int32
scans of a picture the compact form cannot carry). Device side, one call
chain per picture (codec/devsteps.py): dequantization, inverse subband
transform, motion-compensated prediction and reconstruction, the in-loop
filters (ops/filters.py, a hand-written CUDA wavefront on the card) and
border extension into the device reference chain; only the visible
planes come back, once per chunk of frames.

Every picture stays on the device chain, also where the twin drops to
its host chain, which gives the same bytes: a plane with a bad
end-of-plane marker (logged at warning level) decodes as the reference
decodes it, a P plane against an all-zero residual and an intra plane
zeroed before the filter; at a degenerate geometry (`_needs_arena`) the
one-frame steps thread the arena, the reference's shared transform
scratch (3 * width int32, allocated at the first metadata packet that
needs it, kept for the rest of the stream); scans the compact upload
cannot carry go up dense. Such pictures take the one-frame steps.
"""
import numpy as np
import torch

from .. import default_device
from ..bitstream import BitReader
from ..core import constants as K
from ..core import intmath as im
from ..core.frame import Frame, coef_dims, plane_dims
from ..ops import hzcc, mc, sbt
from ..utils import log, packet
from ..utils.trace import stage
from . import motion
from . import plane as planecode

DEC_OK = 0
DEC_ERROR = 1
DEC_EOS = 2
DEC_GOT_META = 3

def compute_filter_q(cfg_like, q):
    """(ref: src/bmc.c:376-388)."""
    psyf = hzcc.spatial_psy_factor(cfg_like, -1)
    if q > 1536:
        q = 1536
    q += q * psyf >> (7 + 3)
    if q < 1024:
        q = 512 + q // 2
    return q


class _PCfg:
    """Per-frame static parameters shared by the device ops."""

    def __init__(self, meta, blk_w, blk_h, isP, lossless, do_psy=0):
        self.meta = meta
        self.blk_w, self.blk_h = blk_w, blk_h
        self.nbh = im.udiv_round_up(meta.width, blk_w)
        self.nbv = im.udiv_round_up(meta.height, blk_h)
        self.isP = isP
        self.lossless = lossless
        self.do_psy = do_psy
        self.cdims = coef_dims(meta.subsamp, meta.width, meta.height)
        self.pdims = plane_dims(meta.subsamp, meta.width, meta.height)

    @property
    def psyf_all(self):
        return hzcc.spatial_psy_factor(self, -1)

    def hzcc_cfg(self, c):
        cw, ch = self.cdims[c]
        return hzcc.HzccCfg(cw, ch, c == 0, self.isP, self.lossless,
                            self.nbh, self.nbv, self.blk_w, self.blk_h,
                            self.meta.width, self.meta.height,
                            self.meta.subsamp, self.do_psy)

    def sbt_cfg(self, c):
        cw, ch = self.cdims[c]
        return sbt.SbtCfg(cw, ch, c == 0, self.isP, self.lossless,
                          self.nbh, self.nbv)

    def mc_cfg(self, c):
        pw, ph = self.pdims[c]
        sh = K.fmt_h_shift(self.meta.subsamp) if c else 0
        sv = K.fmt_v_shift(self.meta.subsamp) if c else 0
        return mc.McCfg(pw, ph, self.blk_w >> sh, self.blk_h >> sv,
                        self.nbh, self.nbv, sh, sv, c == 0, self.lossless)


def _needs_arena(meta):
    """True when the stream's geometry makes the reference's shared
    subband scratch observable (degenerate 1-px transform levels at
    extreme aspect ratios): the decode must thread the arena state."""
    for lossless in (False, True):
        for c, (cw, ch) in enumerate(
                coef_dims(meta.subsamp, meta.width, meta.height)):
            if sbt.degenerate(sbt.SbtCfg(cw, ch, c == 0, False, lossless,
                                         1, 1)):
                return True
    return False


def _filter_scalars(job):
    """(fq, fthresh) of a picture job (ref: bmc.c:376-457)."""
    fq = compute_filter_q(job["pcfg"].hzcc_cfg(0), job["quant"])
    return fq, 32 * (14 - im.lb2(fq))


def _mv_grids(mf):
    return [mf.grid(getattr(mf, a)).astype(np.int32)
            for a in ("x", "y", "flags", "submask", "dc")]


class Decoder:
    def __init__(self, draw_info=0, device=None):
        self.meta = None
        self.ref_dev = None       # device chain: bordered recon planes
        self.draw_info = draw_info
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._use_arena = False
        self._arena = None        # the reference's flat scratch, (3*w,)

    def _up(self, a):
        """Host array (or a tuple of them) -> tensor(s) on the device."""
        if isinstance(a, tuple):
            return tuple(self._up(x) for x in a)
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def decode_packet_lazy(self, buf):
        """Decode one packet buffer with a deferred pixel fetch: returns
        (code, realize|None, fno) where realize() -> Frame; the fetch of
        the visible pixels happens inside realize(), so a caller that
        decodes packet N+1 first overlaps it with the device work."""
        code, job, fno = self.parse_packet(buf)
        if job is None:
            return code, None, fno
        return self._execute_job(job)

    def parse_packet(self, buf):
        """Host phase of packet decode: header, metadata/EOS handling,
        and — for picture packets — stability/motion deserialization plus
        the native entropy decode of the three planes. Returns (code,
        job|None, fno): job is a dict of everything the device phase
        needs, consumed by _execute_job (one frame) or batched by
        decode_stream_chunked (many frames, one call chain)."""
        r = BitReader(buf)
        pkt_type = packet.parse_packet_hdr(r)
        if pkt_type is None:
            return DEC_ERROR, None, -1
        if not K.pt_is_pic(pkt_type):
            if pkt_type == K.PT_META:
                self.meta = packet.decode_metadata(r)
                self._use_arena = _needs_arena(self.meta)
                if self._use_arena and self._arena is None:
                    log.warning("%dx%d: degenerate transform levels; "
                                "decoding with the arena",
                                self.meta.width, self.meta.height)
                    self._arena = torch.zeros(3 * self.meta.width,
                                              dtype=torch.int32,
                                              device=self.device)
                return DEC_GOT_META, None, -1
            if pkt_type == K.PT_EOS:
                return DEC_EOS, None, -1
            return DEC_ERROR, None, -1
        if self.meta is None:
            return DEC_OK, None, -1

        meta = self.meta
        has_ref = K.pt_has_ref(pkt_type)
        is_ref = K.pt_is_ref(pkt_type)

        r.align()
        fno = r.get_bits(32)
        r.align()
        blk_w = 16 << r.get_ueg()
        blk_h = 16 << r.get_ueg()
        if not (K.MIN_BLOCK_SIZE <= blk_w <= K.MAX_BLOCK_SIZE
                and K.MIN_BLOCK_SIZE <= blk_h <= K.MAX_BLOCK_SIZE):
            return DEC_ERROR, None, -1
        r.align()
        stats = [K.ONE_MARKER] * K.MAX_STAT
        stats[K.STABLE_STAT] = r.get_bit()
        if not has_ref:
            stats[K.MAINTAIN_STAT] = r.get_bit()
            stats[K.RINGING_STAT] = r.get_bit()
        else:
            stats[K.MODE_STAT] = r.get_bit()
            stats[K.EPRM_STAT] = r.get_bit()
        do_filter = r.get_bit()
        quant = r.get_bits(K.MAX_QP_BITS)
        lossless = quant == 1
        if r.get_bit():
            r.get_bits(15)
        r.align()

        pcfg = _PCfg(meta, blk_w, blk_h, has_ref, lossless)
        nblk = pcfg.nbh * pcfg.nbv
        blockdata = motion.decode_stability_blocks(r, buf, nblk, has_ref,
                                                   stats)
        mf = None
        if has_ref:
            mf = motion.decode_motion(r, buf, pcfg.nbh, pcfg.nbv, stats,
                                      blockdata)
        else:
            motion.decode_intra_meta(r, buf, nblk, stats, blockdata)
        r.align()

        bd_grid = blockdata.reshape(pcfg.nbv, pcfg.nbh)
        vs = []
        lls = []
        bad_planes = []
        for c in range(3):
            cw, ch = pcfg.cdims[c]
            ok, ll, v = planecode.decode_plane(r, cw, ch)
            if not ok:
                bad_planes.append(c)  # decode continues like the reference
                log.warning("corrupt plane %d (bad EOP)", c)
            vs.append(v)
            lls.append(np.int32(ll))
        from . import devsteps
        cvs, dense = devsteps.scan_upload(pcfg, vs, lossless)
        job = dict(fno=fno, has_ref=has_ref, is_ref=is_ref, meta=meta,
                   pcfg=pcfg, blk_w=blk_w, blk_h=blk_h, quant=quant,
                   lossless=lossless, do_filter=do_filter,
                   blockdata=blockdata, bd_grid=bd_grid, mf=mf,
                   vs=vs, cvs=cvs, dense=dense, lls=lls,
                   bad_planes=bad_planes)
        return DEC_OK, job, fno

    def _execute_job(self, job):
        """Device phase of one picture packet (see parse_packet)."""
        if job["has_ref"] and self.ref_dev is None:
            return DEC_ERROR, None, -1   # a P frame with no reference
        return self._decode_picture_chain(job)

    def _present(self, out, blockdata, mf, pcfg, has_ref):
        if self.draw_info:
            from . import drawinfo
            shown = out.clone(border=False)
            drawinfo.draw_info(shown.view(0), blockdata, mf, pcfg,
                               self.draw_info, has_ref)
            return shown
        return out

    def _frame_of(self, flat, job):
        """The visible payload of one frame -> a bordered Frame."""
        pcfg, meta = job["pcfg"], job["meta"]
        out = Frame(meta.subsamp, meta.width, meta.height, border=True)
        off = 0
        for c in range(3):
            pw, ph = pcfg.pdims[c]
            out.view(c)[:, :] = flat[off:off + ph * pw].reshape(ph, pw)
            off += ph * pw
        return self._present(out, job["blockdata"], job["mf"], pcfg,
                             job["has_ref"])

    def _decode_picture_chain(self, job):
        """Device-resident decode of one picture: dequant + inverse SBT +
        MC + in-loop filters + border extension; the reference planes
        never leave the device, only the visible output is fetched (in
        realize)."""
        from . import devsteps
        meta = self.meta
        fq, fthresh = _filter_scalars(job)
        cfg = (meta.width, meta.height, meta.subsamp, job["blk_w"],
               job["blk_h"], job["lossless"])
        up = self._up
        args = (up(tuple(job["cvs"])), up(job["bd_grid"]),
                up(np.int32(job["quant"])), up(np.asarray(job["lls"],
                                                          np.int32)))
        scal = (up(np.int32(fq)), up(np.int32(fthresh)),
                up(np.int32(job["do_filter"])), tuple(job["bad_planes"]),
                self._arena if self._use_arena else None)
        if job["has_ref"]:
            mv = tuple(up(g) for g in _mv_grids(job["mf"]))
            tmc = up(np.int32(K.temporal_mc(job["fno"])))
            step = devsteps.make_pd_chain_step(*cfg, meta.inter_sharpen,
                                               job["dense"])
            packed, chain = step(*args, tuple(self.ref_dev["recon"]), *mv,
                                 tmc, *scal)
        else:
            packed, chain = devsteps.make_id_chain_step(
                *cfg, job["dense"])(*args, *scal)
        if job["is_ref"]:
            self.ref_dev = chain

        def realize():
            return self._frame_of(packed.cpu().numpy(), job)

        return DEC_OK, realize, job["fno"]

    def _dispatch_multi(self, kind, jobs):
        """One call chain for a run of chain-eligible picture jobs. kind
        "p": consecutive ref P frames, the device reference chain threaded
        through them; kind "i": independent non-ref intra frames as one
        batch. Returns the device (K, npix) visible payload (one fetch for
        all K frames); for "p" the reference chain advances to the last
        frame's recon. Byte-identical to per-frame calls."""
        from . import devsteps
        meta = jobs[0]["meta"]
        up = self._up
        dense = jobs[0]["dense"]   # one per chunk: it is part of the key
        if dense:
            vs = tuple(up(np.stack([j["cvs"][c] for j in jobs]))
                       for c in range(3))
        else:
            vs = tuple(tuple(up(np.stack([j["cvs"][c][k] for j in jobs]))
                             for k in range(len(jobs[0]["cvs"][c])))
                       for c in range(3))
        bd = up(np.stack([j["bd_grid"] for j in jobs]))
        q = up(np.asarray([j["quant"] for j in jobs], np.int32))
        lls = up(np.stack([np.asarray(j["lls"], np.int32) for j in jobs]))
        fqs = [_filter_scalars(j) for j in jobs]
        fq = up(np.asarray([f[0] for f in fqs], np.int32))
        fthresh = up(np.asarray([f[1] for f in fqs], np.int32))
        df = up(np.asarray([j["do_filter"] for j in jobs], np.int32))
        cfg = (meta.width, meta.height, meta.subsamp, jobs[0]["blk_w"],
               jobs[0]["blk_h"], jobs[0]["lossless"])
        if kind == "p":
            grids = [up(np.stack(g)) for g in
                     zip(*(_mv_grids(j["mf"]) for j in jobs))]
            tmc = up(np.asarray([K.temporal_mc(j["fno"]) for j in jobs],
                                np.int32))
            fn = devsteps.make_pd_chain_multi(*cfg, meta.inter_sharpen,
                                              dense)
            packed, chain = fn(vs, bd, q, lls, tuple(self.ref_dev["recon"]),
                               *grids, tmc, fq, fthresh, df)
            self.ref_dev = chain
            return packed
        return devsteps.make_id_chain_multi(*cfg, dense)(vs, bd, q, lls, fq,
                                                         fthresh, df)


def from_reference(job, ref_recon, device=None):
    """A `dsv2_tpu` decoder's state in mid-stream as the port's: `job` is
    a dict from `dsv2_tpu`'s `Decoder.parse_packet`, `ref_recon` that
    decoder's three bordered reference planes as numpy uint8 (its device
    chain's "recon" or its host Frame's planes). Returns (the port's job,
    the port's device reference chain); a Decoder with meta = job["meta"]
    and ref_dev = the chain decodes the job with _execute_job. Reads the
    objects by attribute only, so nothing of `dsv2_tpu` is imported."""
    from ..utils.packet import VideoMeta
    from . import devsteps
    device = torch.device(device) if device is not None else default_device()
    m = job["meta"]
    meta = VideoMeta(**{k: getattr(m, k)
                        for k in VideoMeta.__dataclass_fields__})
    pcfg = _PCfg(meta, job["blk_w"], job["blk_h"], job["has_ref"],
                 job["lossless"])
    mf = None
    if job["mf"] is not None:
        mf = motion.MotionField(pcfg.nbh, pcfg.nbv)
        for a in ("x", "y", "flags", "err", "dc", "submask"):
            setattr(mf, a, np.array(getattr(job["mf"], a)))
    vs = [np.array(v, np.int32) for v in job["vs"]]
    out = dict(job, meta=meta, pcfg=pcfg, mf=mf, vs=vs,
               blockdata=np.array(job["blockdata"]),
               bd_grid=np.array(job["bd_grid"]),
               lls=[np.int32(x) for x in job["lls"]],
               bad_planes=list(job["bad_planes"]))
    out["cvs"], out["dense"] = devsteps.scan_upload(pcfg, vs,
                                                    job["lossless"])
    chain = {"recon": [torch.from_numpy(np.array(p, np.uint8)).to(device)
                       for p in ref_recon]}
    return out, chain


def _auto_chunk(pcfg):
    """Frames per fused decode call chain: bound the staged visible payload
    (and the batched working set) to ~24 MB."""
    npix = sum(pw * ph for pw, ph in pcfg.pdims)
    return max(2, min(32, (24 << 20) // max(npix, 1)))


class ResidentSum:
    """Digest accumulator for device-resident decode: the decoded pixel
    payloads never leave the device; a running pixel sum does instead
    (one scalar fetch at the end, in total()), modulo 2^32 as the twin's
    int32 wraparound sum."""

    def __init__(self):
        self._dev = None   # device scalar (no host sync until total)
        self._host = 0

    def add_dev(self, packed):
        s = packed.to(torch.int64).sum()
        self._dev = s if self._dev is None else self._dev + s

    def add_host(self, frame, pcfg):
        for c in range(3):
            self._host += int(frame.view(c).astype(np.int64).sum())

    def total(self):
        t = self._host
        if self._dev is not None:
            t += int(self._dev)
        return t & 0xFFFFFFFF


def decode_stream_chunked(stream, chunk=None, decoder=None, resident=None):
    """Decode a .dsv stream with multi-frame call chains: runs of
    consecutive ref P pictures (same geometry) become one chained call and
    one (K, npix) pixel fetch, and runs of non-ref intra pictures one
    batched call. Yields (fno, meta, Frame) in stream order,
    byte-identical to decode_stream (the K-frame bodies are the
    single-frame programs). One chunk of pipelining: the host entropy
    decode of the next chunk overlaps the device work and fetch of the
    previous one. Anything irregular — metadata changes, non-ref P, a
    P frame without a reference, a picture with a corrupt plane, a
    degenerate geometry (the arena) — flushes the run and takes the
    single-frame path.

    resident: a ResidentSum — decoded pixels stay on the device; chunked
    runs update the digest on the device and the yielded Frame is None
    (single-frame pictures still realize on the host and fold into the
    digest)."""
    dec = decoder or Decoder()
    pend = []   # chain-eligible jobs, all sharing pend[0]["key"]
    outq = []   # dispatched, unrealized: (tag, payload, jobs)

    def jkey(job, kind):
        m = job["meta"]
        return (kind, m.width, m.height, m.subsamp, job["blk_w"],
                job["blk_h"], job["lossless"], m.inter_sharpen, job["dense"])

    def kind_of(job):
        if dec._use_arena or job["bad_planes"]:
            return None
        if job["has_ref"]:
            # every chunked P must advance the chain; a non-ref P or a
            # chain-less start takes the single-frame path
            return ("p" if job["is_ref"] and dec.ref_dev is not None
                    else None)
        return "i" if not job["is_ref"] else None

    def run_one(job):
        with stage("decode.dispatch"):
            code, realize, _ = dec._execute_job(job)
        if code == DEC_OK and realize is not None:
            outq.append(("one", realize, [job]))

    def flush():
        if not pend:
            return
        jobs = pend[:]
        del pend[:]
        if len(jobs) == 1:
            run_one(jobs[0])
            return
        with stage("decode.dispatch"):
            payload = dec._dispatch_multi(jobs[0]["kind"], jobs)
        outq.append(("multi", payload, jobs))

    def realize_entry(entry):
        tag, payload, jobs = entry
        if tag == "one":
            j = jobs[0]
            with stage("decode.fetch"):
                frame = payload()
            if resident is not None:
                resident.add_host(frame, j["pcfg"])
                frame = None
            yield j["fno"], j["meta"], frame
            return
        if resident is not None:
            resident.add_dev(payload)
            for j in jobs:
                yield j["fno"], j["meta"], None
            return
        with stage("decode.fetch"):
            flat = payload.cpu().numpy()
            frames = [dec._frame_of(flat[k], j) for k, j in enumerate(jobs)]
        for j, frame in zip(jobs, frames):
            yield j["fno"], j["meta"], frame

    for t, buf in packet.iter_packets(stream):
        with stage("decode.parse"):
            code, job, fno = dec.parse_packet(buf)
        if code == DEC_EOS:
            break
        if job is None:
            continue
        k = kind_of(job)
        if k is None or (pend and pend[0]["key"] != jkey(job, k)):
            flush()
        if k is None:
            run_one(job)
        else:
            job["kind"] = k
            job["key"] = jkey(job, k)
            pend.append(job)
            if len(pend) >= (chunk or _auto_chunk(job["pcfg"])):
                flush()
        while len(outq) > 1:
            yield from realize_entry(outq.pop(0))
    flush()
    while outq:
        yield from realize_entry(outq.pop(0))


def decode_stream(stream, device=None):
    """Decode a .dsv stream; yields (fno, Frame). One-frame pipeline:
    frame N's pixel fetch overlaps packet N+1's host entropy decode and
    device work."""
    dec = Decoder(device=device)
    prev = None
    for t, buf in packet.iter_packets(stream):
        code, realize, fno = dec.decode_packet_lazy(buf)
        if code == DEC_EOS:
            break
        if code != DEC_OK or realize is None:
            continue
        if prev is not None:
            yield prev[0], prev[1]()
        prev = (fno, realize)
    if prev is not None:
        yield prev[0], prev[1]()
