"""Rate control: CRF / ABR / CQP quality-to-quant (host scalar math).

Exact port of the reference's experimental rate controller
(ref: src/dsv_encoder.c:72-467). All divisions on potentially negative
values use truncating semantics via intmath.divt.
"""
from ..core import constants as K
from ..core import intmath as im
from ..core.intmath import divt, clamp


def rc_qual_pct(pct):
    return pct * K.RC_QUAL_SCALE


def sample_point(v):
    """(ref: dsv_encoder.c:72-88)."""
    v = (100 * K.RC_QUAL_SCALE) - v
    whole = v // (10 * K.RC_QUAL_SCALE)
    frac = v % (10 * K.RC_QUAL_SCALE)
    ifrac = (10 * K.RC_QUAL_SCALE) - frac
    lo = 1 << (whole + 0)
    hi = 1 << (whole + 1)
    qp = ((ifrac * lo + frac * hi) // (10 * K.RC_QUAL_SCALE)) - 1
    return clamp(qp * 4, 0, K.MAX_QP)


def qual_to_qp(v):
    """(ref: dsv_encoder.c:90-106)."""
    d_hi = (100 * K.RC_QUAL_SCALE) - v
    if d_hi < 60:
        return d_hi + 16
    v = v * 2
    actv = v // 3
    frac = v % 3
    a = sample_point(actv)
    b = sample_point(actv + 1)
    return (a * (3 - frac) + frac * b) // 3


def frame_luma_avg(view):
    """Per-row truncating average of averages (ref: dsv_encoder.c:108-127)."""
    h, w = view.shape
    avg = 0
    rows = view.astype('int64').sum(axis=1) // w
    return int(rows.sum()) // h


def _dark_luma_avg(enc, d):
    """frame_luma_avg of the coarsest pyramid level. When every pyramid
    level has even dimensions the downsample chain never reads the border
    apron, so the native runtime computes the value directly from the
    padded frame — skipping the host-side pyramid build entirely."""
    lv = enc.pyramid_levels
    w, h = d.padded.width, d.padded.height
    ww, hh = w, h
    even = lv >= 1
    for _ in range(lv):
        if ww % 2 or hh % 2:
            even = False
            break
        ww //= 2
        hh //= 2
    if even:
        from .. import native
        return native.luma_avg_ds(d.padded.view(0), lv)
    return frame_luma_avg(d.pyramid[lv - 1].view(0))


def quality2quant(enc, d, prev_I, forced_intra):
    """(ref: dsv_encoder.c:252-467). enc = Encoder state, d = frame data.
    Returns quant; mutates enc.rc_qual etc."""
    q = enc.rc_qual
    has_ref = d.params.has_ref
    SQR = lambda x: x * x

    if enc.rc_mode == K.RC_CRF:
        vfmt = enc.meta
        bound = rc_qual_pct(25)
        minq = enc.min_quality if has_ref else enc.min_I_frame_quality
        maxq = enc.max_quality
        anchor = clamp(enc.quality, minq, maxq)
        fps = (vfmt.fps_num << 5) // vfmt.fps_den
        gop = clamp(enc.gop, 1, (10 * fps) >> 5)
        sqst = SQR(enc.motion_static) // 75
        if sqst < enc.motion_static:
            sqst = enc.motion_static
        if not has_ref:
            plex = (2 if forced_intra else 1) * sqst - enc.motion_chaos
        else:
            plex = (SQR(min(enc.avg_err, divt(enc.motion_chaos, 3))) // 2
                    + sqst - 3 * enc.motion_chaos)
        plex = divt(plex * gop * vfmt.fps_den, vfmt.fps_num << 4)
        plex = clamp(plex, -(bound // 4), bound // 4)
        clamped_avg = max(enc.rf_avg, enc.quality)
        moving_targ = (1 * anchor + 3 * clamped_avg + 2) >> 2
        moving_targ = clamp(moving_targ, enc.quality - bound,
                            enc.quality + bound)
        if enc.do_dark_intra_boost:
            la = _dark_luma_avg(enc, d)
            if la < 80:
                step = (80 - la) // 5
                step = clamp(step, 5, 16) - 5
                plex += SQR(step) // 4
        q = moving_targ + plex
        if not has_ref:
            backpressure = divt(K.RC_QUAL_MAX - q, 1 + enc.motion_chaos // 4)
            q += divt(backpressure * gop * vfmt.fps_den, vfmt.fps_num << 4)
        q = clamp(q, enc.quality - bound, enc.quality + bound)
        q = clamp(q, minq, maxq)
        enc.rc_qual = max(q, 0)
    elif enc.rc_mode == K.RC_ABR:
        vfmt = enc.meta
        fps = (vfmt.fps_num << 5) // vfmt.fps_den
        if fps == 0:
            fps = 1
        if enc.prev_complexity < 0:
            enc.prev_complexity = enc.curr_complexity
        target_rf = ((enc.bitrate << 5) // fps) >> 3
        rf = enc.rf_avg
        if rf == 0:
            rf = target_rf
        direc = -1 if (rf - target_rf) > 0 else 1
        enc.min_q_step = clamp(enc.min_q_step, 1, K.RC_QUAL_MAX)
        enc.max_q_step = clamp(enc.max_q_step, 1, K.RC_QUAL_MAX)
        if not has_ref:
            dif = abs(rf - target_rf)
            if dif > 32768:
                dif = 32768
            delta = (dif * dif) // ((32 if direc > 0 else 64) * target_rf)
            if delta > rc_qual_pct(12):
                delta -= rc_qual_pct(8)
            elif delta > rc_qual_pct(8):
                delta -= rc_qual_pct(4)
            elif delta > rc_qual_pct(4):
                delta -= rc_qual_pct(2)
            delta = min(delta, rc_qual_pct(25))
            q = max(q, enc.avg_P_frame_q) + direc * delta
            if enc.prev_complexity < 15:
                q += rc_qual_pct(2)
            elif enc.prev_complexity < 30:
                q += rc_qual_pct(1)
            elif enc.prev_complexity > 60:
                q -= rc_qual_pct(2)
            elif enc.prev_complexity > 40:
                q -= rc_qual_pct(1)
            enc.prev_I_frame_quality = q
        else:
            delta = (abs(rf - target_rf) * rc_qual_pct(100)) // target_rf
            if direc < 0 and delta < enc.min_q_step:
                delta = 0
            delta = min(delta, enc.max_q_step * (1 if direc > 0 else 8))
            q += direc * delta
        low_p = enc.avg_P_frame_q - rc_qual_pct(4)
        low_p = clamp(low_p, enc.min_quality, enc.max_quality)
        minq = low_p if has_ref else enc.min_I_frame_quality
        if enc.do_dark_intra_boost and not has_ref:
            la = frame_luma_avg(d.pyramid[enc.pyramid_levels - 1].view(0))
            if la < 80:
                step = (80 - la) // 5
                q += clamp(step, 5, 16)
        q = clamp(q, minq, enc.max_quality)
        q = clamp(q, 0, K.RC_QUAL_MAX)
        enc.rc_qual = q
        enc.prev_complexity = enc.curr_complexity
        if enc.rc_pergop:
            q = enc.prev_I_frame_quality
            q = clamp(q, enc.min_quality, enc.max_quality)
        elif d.fnum > 0 and has_ref:
            dist = abs(int(d.fnum) - int(prev_I))
            gop = clamp(enc.gop, 1, 60)
            if dist >= enc.gop // 2:
                step = rc_qual_pct(8)
                dist = abs(int(d.fnum) - (int(prev_I) + gop // 2))
                closeness = step * dist // max(gop // 2, 1)
                closeness = step - closeness
            else:
                step = rc_qual_pct(8)
                closeness = step * dist // max(gop // 2, 1)
            qa = clamp(closeness, 0, step)
            q += qa // 2
            erradd = clamp((enc.avg_err * enc.avg_err) >> 1, 0,
                           rc_qual_pct(16))
            q -= erradd
            q = clamp(q, low_p, enc.max_quality)
            if enc.gop <= ((2 * fps) >> 5):
                if enc.prev_I_frame_quality < q:
                    q = enc.prev_I_frame_quality
                else:
                    q = (3 * q + 1 * enc.prev_I_frame_quality) >> 2
                q = clamp(q, enc.min_quality, enc.max_quality)
    else:  # CQP
        q = enc.quality
        enc.rc_qual = q

    quant = qual_to_qp(q)
    if d.params.lossless:
        quant = 1
    enc.prev_quant = quant
    return quant


def estimate_bitrate(quality_pct, gop, meta):
    """(ref: src/util.c:21-57)."""
    fps = (meta.fps_num + meta.fps_den // 2) // meta.fps_den
    if meta.subsamp in (K.SUBSAMP_444,):
        bpf = 352 * 288 * 3
    elif meta.subsamp in (K.SUBSAMP_422, K.SUBSAMP_UYVY):
        bpf = 352 * 288 * 2
    elif meta.subsamp in (K.SUBSAMP_420, K.SUBSAMP_411):
        bpf = 352 * 288 * 3 // 2
    elif meta.subsamp == K.SUBSAMP_410:
        bpf = 352 * 288 * 9 // 8
    else:
        bpf = 352 * 288 * 3
    if gop == K.GOP_INTRA:
        bpf *= 4
    if meta.width < 320 and meta.height < 240:
        bpf //= 4
    maxdimratio = (((meta.width + meta.height) // 2) << 8) // 352
    bpf = bpf * maxdimratio >> 8
    bps = bpf * fps
    return (bps // (26 - quality_pct // 4)) * 3 // 2


def estimate_quality(bps, gop, meta):
    """(ref: src/util.c:59-76)."""
    bestq, best = 50, None
    for q in range(100):
        rate = estimate_bitrate(q, gop, meta)
        dif = abs(rate - bps)
        if best is None or dif < best:
            bestq, best = q, dif
    return im.clamp(bestq, 0, 99)
