"""DSV2 v2.8 encoder session.

Port of `dsv2_tpu/codec/encoder.py`: host GOP state, rate control,
scene change detection, packetization and the motion/metadata
serializers around one device step per frame (see devsteps.py). Rate
control (`codec/rc`), scene change detection (`codec/scd`), the intra
analysis (`ops/blockanalysis.intra_analysis`) and the serializers
(`codec/motion`) are the port's copies of `dsv2_tpu`'s host modules.

`gop == 0` codes every frame intra with no reference. Any other gop runs
the twin's device reference chain: the input prep, the motion search
(codec/hme: a hand-written CUDA kernel on the card), the P or intra
step with reconstruction, the in-loop filters, border extension and the
pyramids stay on the device; the host reads back only the motion field
and the entropy-coded scans. The twin's host reference path (host motion
search, host in-loop filters) is not ported.

Every device step of the chain (`input_prep`, `i_chain`, `p_chain`, the
motion search's `hme_pl` or `hme_gang`) goes to `dev_submit` as a lane of
its builder (devsteps.make_*_lanes, parallel/dynbatch's contract). Under
lockstep that is the batcher's submit, whose flush spans cover the
steps. Outside it, it is the encoder's own method: the step as a flush
of one lane (devsteps.run_one; on the card the P chain's is a replay of
its CUDA graph), in a span `encode.dispatch.<step>` (`hme` for the
search) with the frame's `fnum`: its host enqueue and the waits inside
it (utils/trace). (ref: src/dsv_encoder.c)
"""
import numpy as np
import torch

from .. import default_device
from ..bitstream import BitWriter
from ..core import constants as K
from ..core import intmath as im
from ..core.frame import B, Frame, ds2x_luma
from ..ops import blockanalysis, hzcc
from ..parallel import xfer
from ..utils import packet
from ..utils.packet import VideoMeta
from ..utils.trace import stage
from . import devsteps, motion, rc
from . import plane as planecode
from .decoder import _PCfg, compute_filter_q

class Params:
    """Per-frame coding parameters (ref: DSV_PARAMS, src/dsv.h:242-268)."""

    def __init__(self, meta, effort, do_psy):
        self.meta = meta
        self.effort = effort
        self.do_psy = do_psy
        self.is_ref = 0
        self.has_ref = 0
        self.blk_w = self.blk_h = 16
        self.nbh = self.nbv = 0
        self.temporal_mc = 0
        self.lossless = False

    @property
    def psyf_all(self):
        return hzcc.spatial_psy_factor(self, -1)

    # duck-typed fields for hzcc.spatial_psy_factor
    @property
    def vid_w(self):
        return self.meta.width

    @property
    def vid_h(self):
        return self.meta.height


class EncData:
    """Per-frame bundle (ref: DSV_ENCDATA, src/dsv_encoder.h:49-66)."""

    def __init__(self, fnum, padded):
        self.fnum = fnum
        self.padded = padded          # bordered+extended source Frame
        self._pyramid = []
        self._pyramid_fn = None       # lazy builder (CRF dark-boost may read
                                      # the smallest level)
        self.params = None
        self.quant = 0
        self.refdata = None           # the reference frame's EncData
        self.final_mvs = None
        self.dev = None               # device reference chain: padded/pyr
                                      # (input prep) + recon/rpyr (chain)

    @property
    def pyramid(self):
        if self._pyramid_fn is not None:
            self._pyramid = self._pyramid_fn()
            self._pyramid_fn = None
        return self._pyramid

    @pyramid.setter
    def pyramid(self, v):
        self._pyramid = v
        self._pyramid_fn = None


class Stats:
    def __init__(self):
        z = ("inum pnum iqual pqual isize psize mb mbI mbP mbdc mbsub eprm "
             "skip fpx hpx qpx fpy hpy qpy ifnum pfnum").split()
        for n in z:
            setattr(self, n, 0)
        self.mbsubs = [0, 0, 0, 0]
        self.iminq = self.pminq = self.imins = self.pmins = 2**31 - 1
        self.imaxq = self.pmaxq = self.imaxs = self.pmaxs = 0
        self.blob_fallbacks = 0   # planes re-coded on the host (contract)


class Encoder:
    """(ref: DSV_ENCODER init at src/dsv_encoder.c:1319-1358). `device` is
    where the device steps run (default: DSV2_TORCH_DEVICE)."""

    def __init__(self, device=None):
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.quality = 80 * K.RC_QUAL_SCALE
        self.gop = 48
        self.effort = K.MAX_EFFORT
        self.pyramid_levels = 0
        self.rc_mode = K.RC_CRF
        self.bitrate = 2**31 - 1
        self.rc_pergop = 0
        self.min_q_step = 4
        self.max_q_step = 1
        self.min_quality = self.quality - K.user_qual_to_rc_qual(5)
        self.max_quality = K.RC_QUAL_MAX
        self.min_I_frame_quality = self.quality - K.user_qual_to_rc_qual(2)
        self.prev_I_frame_quality = 0
        self.intra_pct_thresh = 90
        self.stable_refresh = 24
        self.scene_change_pct = 85
        self.do_scd = 1
        self.variable_i_interval = 1
        self.skip_block_thresh = 0
        self.block_size_override_x = -1
        self.block_size_override_y = -1
        self.do_temporal_aq = 1
        self.do_psy = K.PSY_ALL
        self.do_dark_intra_boost = 1
        self.do_intra_filter = 1
        self.do_inter_filter = -1
        self.meta = VideoMeta()
        # state
        self.rc_qual = 0
        self.rf_total = 0
        self.rf_reset = 0
        self.rf_avg = 0
        self.total_P_frame_q = 0
        self.avg_P_frame_q = 0
        self.prev_complexity = -1
        self.curr_complexity = -1
        self.curr_avgmot = 0
        self.curr_intra_pct = 0
        self.curr_scblocks = 0
        self.prev_chaos = -1
        self.motion_chaos = 0
        self.motion_static = 0
        self.avg_err = 0
        self.auto_filter = 0
        self.next_fnum = 0
        self.prev_link = 0
        self.force_metadata = 0
        self.stability = None         # (nblk, 2) int64
        self.refresh_ctr = 0
        self.blockdata = None         # uint8[nblk]
        self.intra_map = None
        self.prev_gop = -1
        self.prev_quant = 0
        self.stats = Stats()
        self.ref = None               # EncData of the reference frame
        self.hme_backend = None       # None: DSV2_HME or "auto" (codec/hme)

    # -- lifecycle ---------------------------------------------------------

    def set_metadata(self, meta: VideoMeta):
        self.meta = meta

    def start(self):
        """(ref: dsv_enc_start, dsv_encoder.c:1360-1383)."""
        self.quality = im.clamp(self.quality, 0, K.RC_QUAL_MAX)
        if self.rc_mode == K.RC_CRF:
            self.rc_qual = im.clamp(self.quality + rc.rc_qual_pct(5),
                                    self.min_I_frame_quality,
                                    self.max_quality)
            self.rf_avg = self.rc_qual
            self.avg_P_frame_q = self.quality
        elif self.rc_mode == K.RC_ABR:
            self.rc_qual = self.quality
            self.avg_P_frame_q = self.quality * 4 // 5
        self.force_metadata = 1

    # -- main entry --------------------------------------------------------

    def encode_frame(self, planes):
        """Encode one frame (y, u, v arrays). Returns a list of packet
        buffers (bytes) with link offsets applied (ref: dsv_enc,
        dsv_encoder.c:1430-1575)."""
        with stage("encode_frame", fnum=self.next_fnum):
            meta = self.meta
            padded = Frame(meta.subsamp, meta.width, meta.height,
                           border=True)
            padded.load(planes)
            padded.extend()
            d = EncData(self.next_fnum, padded)
            self.next_fnum += 1
            gop_start, outbuf = self._encode_one(d)
            bufs = []
            if gop_start:
                mbuf = bytearray(packet.encode_metadata(meta))
                bufs.append(self._link(mbuf))
            bufs.append(self._link(bytearray(outbuf)))
            self._tally(d, len(outbuf))
            return [bytes(b) for b in bufs]

    def end_of_stream(self):
        buf = bytearray(packet.encode_eos())
        packet.set_link_offsets(buf, self.prev_link, 0)
        self.prev_link = 0
        return [bytes(buf)]

    def _link(self, buf):
        next_link = len(buf)
        packet.set_link_offsets(buf, self.prev_link, next_link)
        self.prev_link = next_link
        return buf

    # -- per-frame pipeline --------------------------------------------------

    def _setup_params(self, d):
        """(ref: encode_one_frame, dsv_encoder.c:1184-1241)."""
        p = Params(self.meta, self.effort, self.do_psy)
        w, h = self.meta.width, self.meta.height
        p.temporal_mc = K.temporal_mc(d.fnum)
        p.lossless = self.quality == K.RC_QUAL_MAX

        def size4dim(dim):
            return K.MAX_BLOCK_SIZE if dim > 1280 else K.MIN_BLOCK_SIZE

        p.blk_w, p.blk_h = size4dim(w), size4dim(h)
        if abs(w - h) < min(w, h):
            mins = min(p.blk_w, p.blk_h)
            p.blk_w = p.blk_h = mins
        if self.block_size_override_x >= 0:
            p.blk_w = im.clamp(16 << self.block_size_override_x,
                               K.MIN_BLOCK_SIZE, K.MAX_BLOCK_SIZE)
        if self.block_size_override_y >= 0:
            p.blk_h = im.clamp(16 << self.block_size_override_y,
                               K.MIN_BLOCK_SIZE, K.MAX_BLOCK_SIZE)
        p.nbh = im.udiv_round_up(w, p.blk_w)
        p.nbv = im.udiv_round_up(h, p.blk_h)
        d.params = p
        if self.stability is None:
            self.stability = np.zeros((p.nbh * p.nbv, 2), dtype=np.int64)
            self.blockdata = np.zeros(p.nbh * p.nbv, dtype=np.uint8)
        if self.pyramid_levels == 0:
            lvls = im.lb2(min(w, h))
            maxdim = max(p.nbh, p.nbv)
            while (1 << lvls) > maxdim:
                lvls -= 1
            self.pyramid_levels = im.clamp(lvls, 3, K.MAX_PYRAMID_LEVELS)

    def _mk_pyramid(self, frame):
        """(ref: dsv_encoder.c:493-516)."""
        pyr = []
        prev = frame
        w, h = frame.width, frame.height
        for i in range(self.pyramid_levels):
            f = Frame(frame.subsamp, im.round_shift(w, i + 1),
                      im.round_shift(h, i + 1), border=True)
            ds2x_luma(f, prev)
            f.extend(luma_only=True)
            pyr.append(f)
            prev = f
        return pyr

    def _devchain(self):
        """The device reference chain (every frame of a gop != 0 stream):
        recon, in-loop filters, border extension and the motion search
        pyramids never leave the device."""
        return self.gop != K.GOP_INTRA

    def dev_submit(self, key, builder, args, fetch=None):
        """A device step outside lockstep: the step as a flush of one lane
        (devsteps.run_one) in the span `encode.dispatch.<step>` of the
        frame in flight. Under lockstep the batcher's submit, set on the
        instance, takes its place (parallel/dynbatch)."""
        name = "hme" if key[0].startswith("hme") else key[0]
        with stage("encode.dispatch." + name, fnum=self.next_fnum - 1):
            return devsteps.run_one(key, builder, args, self.device)

    def _input_prep(self, d):
        """Upload the visible planes once; the bordered planes and the
        pyramid are built on the device."""
        meta = self.meta
        vis = tuple(xfer.upload(np.ascontiguousarray(d.padded.view(c)),
                                self.device) for c in range(3))
        cfg = (meta.width, meta.height, meta.subsamp, self.pyramid_levels)
        return self.dev_submit(("input_prep", cfg),
                               devsteps.make_input_prep_lanes, vis,
                               fetch=False)

    def _encode_one(self, d):
        """(ref: encode_one_frame, dsv_encoder.c:1184-1317)."""
        self._setup_params(d)
        p = d.params
        prev_I = self.prev_gop
        if self._devchain():
            # the host pyramid only materializes if CRF dark-boost needs it
            d._pyramid_fn = (lambda padded=d.padded:
                             self._mk_pyramid(padded))
            with stage("encode.input_prep"):
                d.dev = self._input_prep(d)
        else:
            d.pyramid = self._mk_pyramid(d.padded)

        gop_start = 0
        if self.force_metadata or (self.prev_gop + self.gop) <= d.fnum:
            gop_start = 1
            self.prev_gop = d.fnum
            self.force_metadata = 0

        if self.gop == K.GOP_INTRA:
            p.is_ref = 0
            p.has_ref = 0
        else:
            p.is_ref = 1
            if gop_start:
                p.has_ref = 0
            else:
                p.has_ref = 1
                d.refdata = self.ref
            self.ref = d
        self.avg_err = 0

        forced_intra = 0
        if not p.has_ref:
            if self.intra_map is None:
                self.intra_map = np.zeros(p.nbh * p.nbv, dtype=np.uint8)
        else:
            with stage("encode.motion_est"):
                self._motion_est(d)
            with stage("encode.scd"):
                forced_intra = self._scene_change_detection(d)
        if self.variable_i_interval and forced_intra:
            self.prev_gop = d.fnum
        if not p.has_ref:
            self.intra_map[:] = 0

        d.quant = rc.quality2quant(self, d, prev_I, forced_intra)
        self._compute_auto_filter(d)
        outbuf = self._encode_picture(d)
        d.refdata = None    # its chain is consumed; free the device planes
        return gop_start, outbuf

    # -- picture ------------------------------------------------------------

    def _gather_stats(self, d, intramv, stats):
        """(ref: dsv_encoder.c:992-1037)."""
        p = d.params
        nblk = p.nbh * p.nbv
        temp_rc = self.refresh_ctr
        if self.refresh_ctr >= self.stable_refresh:
            temp_rc = 0
        avgdiv = max(temp_rc, 1)
        if p.has_ref:
            fl = d.final_mvs.flags.astype(np.uint32)
            intra = ((fl >> K.MV_BIT_INTRA) & 1).astype(bool)
            skip = ((fl >> K.MV_BIT_SKIP) & 1).astype(bool)
            eprm = ((fl >> K.MV_BIT_EPRM) & 1).astype(bool)
            ns = int((~skip).sum())
            stats[K.MODE_STAT] += 2 * int((intra & ~skip).sum()) - ns
            stats[K.EPRM_STAT] += 2 * int((eprm & ~skip).sum()) - ns
            stats[K.STABLE_STAT] += 2 * int(((~intra) & skip).sum()) - nblk
            return
        fl = intramv.flags
        if d.fnum > 0 and self.do_temporal_aq:
            stable = ((self.stability[:, 0] // avgdiv == 0)
                      & (self.stability[:, 1] // avgdiv == 0))
        else:
            stable = (fl & (1 << K.MV_BIT_SKIP)) != 0
        maint = int(((fl & (1 << K.MV_BIT_MAINTAIN)) != 0).sum())
        ring = int(((fl & (1 << K.MV_BIT_RINGING)) != 0).sum())
        stats[K.MAINTAIN_STAT] += 2 * maint - nblk
        stats[K.RINGING_STAT] += 2 * ring - nblk
        stats[K.STABLE_STAT] += 2 * int(stable.sum()) - nblk

    def _stable_decisions(self, d, intramv):
        """Stable/skip bits + blockdata init + stability accumulation
        (ref: encode_stable_blocks, dsv_encoder.c:797-883)."""
        p = d.params
        nblk = p.nbh * p.nbv
        if self.refresh_ctr >= self.stable_refresh:
            self.refresh_ctr = 0
            self.stability[:] = 0
        avgdiv = max(self.refresh_ctr, 1)
        if p.has_ref:
            return self._stable_decisions_p(d)
        fl = intramv.flags
        if d.fnum > 0 and self.do_temporal_aq:
            stable = ((self.stability[:, 0] // avgdiv == 0)
                      & (self.stability[:, 1] // avgdiv == 0))
        else:
            stable = np.zeros(nblk, dtype=bool)
        stable = stable | ((fl & (1 << K.MV_BIT_SKIP)) != 0)
        self.blockdata[:] = stable.astype(np.uint8) << K.STABLE_BIT
        return stable.astype(np.uint8)

    def _stable_decisions_p(self, d):
        """P branch of _stable_decisions: moving inter blocks accumulate
        motion, skip vectors are zeroed, blockdata gets the P flags."""
        p = d.params
        fps = im.udiv_round(p.meta.fps_num, p.meta.fps_den)
        if fps <= 24:
            dsf = 6
        elif fps <= 30:
            dsf = 4
        elif fps <= 60:
            dsf = 2
        else:
            dsf = 0
        mf = d.final_mvs
        fl = mf.flags.astype(np.uint32)
        skip = ((fl >> K.MV_BIT_SKIP) & 1).astype(bool)
        intra = ((fl >> K.MV_BIT_INTRA) & 1).astype(bool)
        simc = ((fl >> K.MV_BIT_SIMCMPLX) & 1).astype(np.uint8)
        stable = (~intra) & skip
        acc = (~intra) & (~skip)
        self.stability[:, 0] += np.where(
            acc, np.abs(mf.x.astype(np.int64)) >> dsf, 0)
        self.stability[:, 1] += np.where(
            acc, np.abs(mf.y.astype(np.int64)) >> dsf, 0)
        mf.x[skip] = 0
        mf.y[skip] = 0
        self.blockdata[:] = (np.where(intra, K.IS_INTRA, 0).astype(np.uint8)
                             | (stable.astype(np.uint8) << K.SKIP_BIT)
                             | (simc << K.SIMCMPLX_BIT))
        return stable.astype(np.uint8)

    def _encode_picture(self, d):
        """(ref: encode_picture, dsv_encoder.c:1039-1173)."""
        p = d.params
        meta = self.meta
        w = BitWriter(1 << 16)
        packet.write_packet_hdr(w, K.make_pt(p.is_ref, p.has_ref))
        w.align()
        w.put_bits(32, d.fnum)

        intramv = None
        if not p.has_ref:
            intramv = blockanalysis.intra_analysis(d.padded, p)

        stats = [K.ONE_MARKER] * K.MAX_STAT
        if self.effort >= 7:
            self._gather_stats(d, intramv, stats)
            for i in range(K.MAX_STAT):
                stats[i] = (K.ZERO_MARKER if stats[i] > 0 else K.ONE_MARKER)
        else:
            stats[K.MAINTAIN_STAT] = K.ZERO_MARKER
            stats[K.RINGING_STAT] = K.ZERO_MARKER

        w.align()
        w.put_ueg(im.lb2(p.blk_w) - 4)
        w.put_ueg(im.lb2(p.blk_h) - 4)
        w.align()
        w.put_bit(stats[K.STABLE_STAT])
        if p.has_ref:
            w.put_bit(stats[K.MODE_STAT])
            w.put_bit(stats[K.EPRM_STAT])
            inter_filter = (self.do_inter_filter == 1
                            or (self.do_inter_filter == -1
                                and self.auto_filter))
            w.put_bit(1 if inter_filter else 0)
        else:
            inter_filter = False
            w.put_bit(stats[K.MAINTAIN_STAT])
            w.put_bit(stats[K.RINGING_STAT])
            w.put_bit(self.do_intra_filter)
        w.put_bits(K.MAX_QP_BITS, d.quant)
        w.put_bit(0)
        w.align()

        stable_bits = self._stable_decisions(d, intramv)
        motion.encode_stable_blocks(w, stable_bits, stats)
        if p.has_ref:
            # prediction/subtraction happen inside the device step
            w.align()
            motion.encode_motion(w, d.final_mvs, stats, self.blockdata)
        else:
            fl = intramv.flags
            self.blockdata |= (((fl >> K.MV_BIT_RINGING) & 1)
                               << K.RINGING_BIT).astype(np.uint8)
            self.blockdata |= (((fl >> K.MV_BIT_MAINTAIN) & 1)
                               << K.MAINTAIN_BIT).astype(np.uint8)
            ring_bits = (fl & (1 << K.MV_BIT_RINGING)) != 0
            maint_bits = (fl & (1 << K.MV_BIT_MAINTAIN)) != 0
            motion.encode_intra_meta(w, ring_bits, maint_bits, stats)

        # image data — one device step for the whole frame
        # (ref: dsv_encoder.c:1134-1161)
        w.align()
        pcfg = _PCfg(meta, p.blk_w, p.blk_h, bool(p.has_ref), p.lossless,
                     do_psy=p.do_psy)
        with stage("encode.device_step"):
            if p.has_ref:
                outs = self._p_step(d, pcfg, inter_filter)
            else:
                outs = self._i_step(d, pcfg)
            if len(outs) > 3:  # chain step: keep the device reference
                d.dev.update(outs[3])
        with stage("encode.fetch"):
            vscans, lls = devsteps.fetch_sparse_outs(outs)
        with stage("encode.serialize"):
            for c in range(3):
                cw, ch = pcfg.cdims[c]
                kind, payload = vscans[c]
                if kind == "blob":
                    planecode.encode_plane_blob(w, payload, lls[c])
                else:
                    self.stats.blob_fallbacks += 1
                    planecode.encode_plane(w, payload, lls[c], cw, ch)
        return w.data()

    def _filter_q(self, pcfg, quant):
        fq = compute_filter_q(pcfg.hzcc_cfg(0), quant)
        return fq, 32 * (14 - im.lb2(fq))

    def _i_step(self, d, pcfg):
        """The intra device step: (buf, smalls, vs), plus the reference
        chain when the frame is a reference (gop != 0)."""
        p = d.params
        meta = self.meta
        dev = self.device
        xs = []
        for c in range(3):
            cw, ch = pcfg.cdims[c]
            pw, ph = pcfg.pdims[c]
            x = np.full((1, ch, cw), 128, dtype=np.uint8)
            x[0, :ph, :] = d.padded.planes[c][B:B + ph, B:B + cw]
            xs.append(xfer.upload(x, dev))
        bd = xfer.upload(np.ascontiguousarray(
            self.blockdata.reshape(1, p.nbv, p.nbh)), dev)
        q = xfer.upload(np.array([d.quant], dtype=np.int32), dev)
        cfg = (meta.width, meta.height, meta.subsamp, p.blk_w, p.blk_h,
               p.lossless, p.do_psy)
        if not (p.is_ref and self._devchain()):
            return devsteps.make_i_encode_step(*cfg)(xs, bd, q)
        fq, fthresh = self._filter_q(pcfg, d.quant)
        cfg += (self.pyramid_levels,)
        return self.dev_submit(("i_chain", cfg), devsteps.make_i_chain_lanes,
                               (xs, bd, q, fq, fthresh, self.do_intra_filter),
                               fetch=True)

    def _p_step(self, d, pcfg, inter_filter):
        """The P device step with the reference chain. The motion field,
        the per-block maps and the frame's scalars go up as one int32
        array (devsteps.p_chain_ints)."""
        p = d.params
        meta = self.meta
        mf = d.final_mvs
        eprm = mf.bit(K.MV_BIT_EPRM)
        mlt = (mf.bit(K.MV_BIT_MAINTAIN)
               & (np.abs(mf.x.astype(np.int32)) < 32)
               & (np.abs(mf.y.astype(np.int32)) < 32))
        grids = np.stack([a.astype(np.int32) for a in (
            mf.x, mf.y, mf.flags, mf.submask, mf.dc, self.blockdata, eprm,
            mlt)]).reshape(8, p.nbv, p.nbh)
        fq, fthresh = self._filter_q(pcfg, d.quant)
        scal = (K.temporal_mc(d.fnum), fq, fthresh, 1 if inter_filter else 0)
        cfg = (meta.width, meta.height, meta.subsamp, p.blk_w, p.blk_h,
               p.lossless, p.do_psy, self.pyramid_levels, meta.inter_sharpen)
        ints = xfer.upload(devsteps.p_chain_ints(grids, d.quant, *scal),
                           self.device)
        return self.dev_submit(("p_chain", cfg), devsteps.make_p_chain_lanes,
                               (d.dev["padded"], d.refdata.dev["recon"], ints),
                               fetch=True)

    # -- P-frame machinery ----------------------------------------------------

    def _motion_est(self, d):
        from . import hme
        hme.motion_est(self, d)

    def _scene_change_detection(self, d):
        from . import scd
        return scd.scene_change_detection(self, d)

    def _compute_auto_filter(self, d):
        """(ref: dsv_encoder.c:518-543)."""
        p = d.params
        SQR = lambda x: x * x
        intra_pct = self.curr_intra_pct
        scblocks = self.curr_scblocks
        chaos = self.motion_chaos
        psy = p.psyf_all
        norm = SQR(d.quant) >> 15
        relerr = ((SQR(intra_pct) + scblocks + self.avg_err * chaos)
                  // max(norm, 1))
        relerr = relerr + (relerr * psy >> 7)
        avg_chaos = (self.prev_chaos + chaos + 1) >> 1
        thresh = 8
        thresh += thresh * psy >> 5
        thresh -= (min(avg_chaos, 48) * psy * max(self.avg_err // 2, 1)
                   // (128 * (thresh - 2)))
        self.auto_filter = 1 if (chaos <= 1 or relerr > thresh) else 0

    # -- post-frame stats -----------------------------------------------------

    def _tally_intra_size(self, outlen, rc_qual):
        """Post-frame I stats (the I branch of the twin's _tally)."""
        st = self.stats
        st.inum += 1
        st.ifnum += 1 if self.do_intra_filter else 0
        st.isize += outlen
        st.iqual += rc_qual
        st.imaxq = max(rc_qual, st.imaxq)
        st.imaxs = max(outlen, st.imaxs)
        st.iminq = min(rc_qual, st.iminq)
        st.imins = min(outlen, st.imins)

    def _tally(self, d, outlen):
        """(ref: dsv_enc, dsv_encoder.c:1471-1570)."""
        p = d.params
        if p.has_ref:
            self._tally_p(d, outlen)
        else:
            self._tally_intra_size(outlen, self.rc_qual)
        if p.has_ref:
            self.refresh_ctr += 1
        if self.rc_mode != K.RC_CQP:
            if self.rc_mode == K.RC_CRF:
                self.rf_total += self.rc_qual
            else:
                self.rf_total += outlen
            self.rf_reset += 1
            if p.has_ref:
                self.total_P_frame_q += self.rc_qual
                self.avg_P_frame_q = self.total_P_frame_q // self.rf_reset
            self.rf_avg = self.rf_total // self.rf_reset
            if self.rf_reset >= K.RF_RESET:
                self.rf_total = self.rf_avg
                self.total_P_frame_q = self.total_P_frame_q // self.rf_reset
                self.rf_reset = 1

    def _tally_p(self, d, outlen):
        """Post-frame P stats: sizes, qualities, block modes and MV
        precisions."""
        p = d.params
        st = self.stats
        st.pnum += 1
        st.pfnum += 1 if self.auto_filter else 0
        st.psize += outlen
        st.pqual += self.rc_qual
        st.pmaxq = max(self.rc_qual, st.pmaxq)
        st.pmaxs = max(outlen, st.pmaxs)
        st.pminq = min(self.rc_qual, st.pminq)
        st.pmins = min(outlen, st.pmins)
        mf = d.final_mvs
        fl = mf.flags.astype(np.int64)
        skip = (fl & (1 << K.MV_BIT_SKIP)) != 0
        intra = ~skip & ((fl & (1 << K.MV_BIT_INTRA)) != 0)
        inter = ~skip & ~intra
        st.eprm += int(((fl & (1 << K.MV_BIT_EPRM)) != 0).sum())
        st.skip += int(skip.sum())
        st.mbI += int(intra.sum())
        st.mbdc += int((intra & ((mf.dc & K.SRC_DC_PRED) != 0)).sum())
        sub = intra & (mf.submask != K.MASK_ALL_INTRA)
        st.mbsub += int(sub.sum())
        for b in range(4):
            st.mbsubs[b] += int((sub & ((mf.submask & (1 << b)) != 0)).sum())
        st.mbP += int(inter.sum())
        for val, fp, hp, qp in ((mf.x, "fpx", "hpx", "qpx"),
                                (mf.y, "fpy", "hpy", "qpy")):
            v = val.astype(np.int64)
            q_ = inter & ((v & 1) != 0)
            h_ = inter & ((v & 1) == 0) & ((v & 3) != 0)
            setattr(st, qp, getattr(st, qp) + int(q_.sum()))
            setattr(st, hp, getattr(st, hp) + int(h_.sum()))
            setattr(st, fp, getattr(st, fp) + int((inter & ~q_ & ~h_).sum()))
        st.mb += p.nbh * p.nbv
