"""dsv2 CLI for the torch port: `python -m dsv2_tpu_torch e -name=value ...`

Same flag surface as `dsv2_tpu`'s CLI (ref: src/dsv_main.c:102-247); the
flag tables, argument parser, overwrite prompt and statistics dump are
`dsv2_tpu.cli`'s own (jax-free). Only intra encoding (`-gop=0`) is ported;
`d` (decode) is not yet (ROADMAP item 16). DSV2_TORCH_DEVICE picks the
device (`cuda`, the default, or `cpu`).
"""
import sys

from dsv2_tpu.cli import (ENC_PARAMS, confirm_overwrite, default_enc_opts,
                          im_clamp, parse_args, print_stats)
from dsv2_tpu.core import constants as K
from dsv2_tpu.utils import y4m
from dsv2_tpu.utils.packet import VideoMeta

__all__ = ["make_encoder", "default_enc_opts", "read_y4m", "cmd_encode",
           "main"]


def read_y4m(path):
    """(frames, meta) of a whole y4m file, as `e -y4m=1` reads it: frames
    is the list of (y, u, v) uint8 planes."""
    frames = []
    with open(path, "rb") as f:
        rdr = y4m.Y4MReader(f)
        while True:
            p = rdr.read_frame()
            if p is None:
                break
            frames.append(p)
    meta = VideoMeta(width=rdr.w, height=rdr.h, subsamp=rdr.subsamp,
                     fps_num=rdr.fps[0], fps_den=rdr.fps[1],
                     aspect_num=rdr.aspect[0], aspect_den=rdr.aspect[1])
    return frames, meta


def make_encoder(meta, opts, device=None):
    """Build a fully configured Encoder from a CLI option dict (exactly the
    reference driver's parameter plumbing, dsv_main.c:555-735) on
    `device` (default: DSV2_TORCH_DEVICE)."""
    from dsv2_tpu.codec import rc

    from .codec.encoder import Encoder

    fps = (meta.fps_num + meta.fps_den // 2) // meta.fps_den
    enc = Encoder(device)
    enc.set_metadata(meta)
    enc.gop = opts["gop"] if opts["gop"] >= 0 else fps
    enc.scene_change_pct = opts["scpct"]
    enc.do_scd = opts["scd"]
    enc.intra_pct_thresh = opts["ipct"]
    enc.quality = opts["qp"]
    enc.skip_block_thresh = opts["skipthresh"]
    enc.rc_mode = opts["rc_mode"]
    enc.rc_pergop = opts["rc_pergop"]
    spec_bps = opts["kbps"]
    if enc.quality == K.user_qual_to_rc_qual(-1):
        if enc.rc_mode != K.RC_ABR or spec_bps == 0:
            qual = 85
        else:
            qual = rc.estimate_quality(spec_bps, enc.gop, meta)
        enc.quality = K.user_qual_to_rc_qual(qual)
    if spec_bps == 0:
        enc.bitrate = rc.estimate_bitrate(
            enc.quality * 100 // K.RC_QUAL_MAX, enc.gop, meta)
    else:
        enc.bitrate = spec_bps
    enc.min_q_step = opts["minqstep"]
    enc.max_q_step = opts["maxqstep"]
    enc.min_quality = opts["minqp"]
    enc.max_quality = opts["maxqp"]
    enc.min_I_frame_quality = opts["iminqp"]
    if enc.rc_mode == K.RC_CRF:
        if enc.min_quality < 0:
            enc.min_quality = enc.quality - K.user_qual_to_rc_qual(5)
        if enc.min_I_frame_quality < 0:
            enc.min_I_frame_quality = enc.quality - K.user_qual_to_rc_qual(2)
    else:
        if enc.min_quality < 0:
            enc.min_quality = 0
        if enc.min_I_frame_quality < 0:
            enc.min_I_frame_quality = K.user_qual_to_rc_qual(5)
    if enc.max_quality < 0:
        enc.max_quality = K.RC_QUAL_MAX
    enc.min_quality = im_clamp(enc.min_quality)
    enc.min_I_frame_quality = im_clamp(enc.min_I_frame_quality)
    enc.max_quality = im_clamp(enc.max_quality)
    enc.pyramid_levels = opts["pyrlevels"]
    enc.stable_refresh = opts["stabref"] or max(1, min(fps, 60))
    enc.do_temporal_aq = opts["tempaq"]
    enc.variable_i_interval = opts["varint"]
    enc.block_size_override_x = opts["bszx"]
    enc.block_size_override_y = opts["bszy"]
    enc.effort = opts["effort"]
    enc.do_psy = opts["psy"]
    enc.do_dark_intra_boost = opts["dib"]
    enc.do_intra_filter = opts["ifilter"]
    enc.do_inter_filter = opts["pfilter"]
    enc.start()
    return enc


def cmd_encode(argv, device=None):
    opts, io = parse_args(argv, ENC_PARAMS)
    if not confirm_overwrite(io):
        return 1
    inp = sys.stdin.buffer if io["inp"] == "-" else open(io["inp"], "rb")
    meta = VideoMeta(width=opts["w"], height=opts["h"], subsamp=opts["fmt"],
                     fps_num=opts["fps_num"], fps_den=opts["fps_den"],
                     aspect_num=opts["aspect_num"],
                     aspect_den=opts["aspect_den"],
                     inter_sharpen=opts["psharp"])
    if opts["y4m"]:
        rdr = y4m.Y4MReader(inp)
        meta.width, meta.height = rdr.w, rdr.h
        meta.subsamp = rdr.subsamp
        meta.fps_num, meta.fps_den = rdr.fps
        meta.aspect_num, meta.aspect_den = rdr.aspect
    else:
        rdr = y4m.RawYUVReader(inp, meta.width, meta.height, meta.subsamp)
    if meta.width % 2 or meta.height % 2:
        raise SystemExit("DSV2 does not support odd dimensions")
    fps = (meta.fps_num + meta.fps_den // 2) // meta.fps_den
    enc = make_encoder(meta, opts, device)

    frno = opts["sfr"]
    nfr = opts["nfr"]
    maxframe = frno + nfr if nfr > 0 else -1
    if frno:
        rdr.seek_to_frame(frno)
    out_chunks = []
    no_more = False
    while True:
        if maxframe > 0 and frno >= maxframe:
            break
        planes = rdr.read_frame()
        if planes is None:
            no_more = True
            break
        out_chunks.extend(enc.encode_frame(planes))
        frno += 1
    if not opts["noeos"] or (no_more and out_chunks):
        out_chunks.extend(enc.end_of_stream())
    data = b"".join(out_chunks)
    out = sys.stdout.buffer if io["out"] == "-" else open(io["out"], "wb")
    out.write(data)
    if io["out"] != "-":
        out.close()
    if inp is not sys.stdin.buffer:
        inp.close()
    if io["verbose"]:
        print_stats(enc, len(data), frno - opts["sfr"], fps)
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in ("e", "d"):
        print("usage: dsv2_tpu_torch <e|d> [options]")
        return 0
    if argv[0] == "d":
        raise NotImplementedError("decode: ROADMAP item 16")
    return cmd_encode(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
