"""dsv2 CLI for the torch port: `python -m dsv2_tpu_torch e|d -name=value ...`

Same flag surface as the reference CLI (ref: src/dsv_main.c:102-247)
and `dsv2_tpu`'s CLI, whose flag tables, argument parser, overwrite
prompt and statistics dump are copied here. Encoding covers intra
(`-gop=0`) and P streams (`-gop=N`: sequential encode_frame on the
device reference chain); decoding (`d`) runs the device-chain decoder on
every stream, corrupt ones and degenerate geometries included.
DSV2_TORCH_DEVICE picks the device (`cuda`, the default, or `cpu`).
"""
import sys

from .core import constants as K
from .utils import y4m
from .utils.packet import VideoMeta

__all__ = ["ENC_PARAMS", "DEC_PARAMS", "make_encoder", "default_enc_opts",
           "read_y4m", "cmd_encode", "cmd_decode", "main"]


def _pct_to_qual(v):
    return K.user_qual_to_rc_qual(v)


def _to_bps(v):
    return v * 1024


_FMT_MAP = {0: K.SUBSAMP_444, 1: K.SUBSAMP_422, 2: K.SUBSAMP_420,
            3: K.SUBSAMP_411, 4: K.SUBSAMP_410, 5: K.SUBSAMP_UYVY}

ENC_PARAMS = {
    "qp": (-1 * K.RC_QUAL_SCALE, -1, 100, _pct_to_qual),
    "effort": (K.MAX_EFFORT, 0, 10, None),
    "w": (352, 16, 1 << 24, None),
    "h": (288, 16, 1 << 24, None),
    "gop": (-1, -1, K.GOP_INF, None),
    "fmt": (K.SUBSAMP_420, 0, 5, lambda v: _FMT_MAP.get(v, K.SUBSAMP_420)),
    "nfr": (-1, -1, 2**31 - 1, None),
    "sfr": (0, 0, 2**31 - 1, None),
    "noeos": (0, 0, 1, None),
    "fps_num": (30, 1, 1 << 24, None),
    "fps_den": (1, 1, 1 << 24, None),
    "aspect_num": (1, 1, 1 << 24, None),
    "aspect_den": (1, 1, 1 << 24, None),
    "ipct": (90, 0, 100, None),
    "pyrlevels": (0, 0, K.MAX_PYRAMID_LEVELS, None),
    "rc_mode": (K.RC_CRF, K.RC_CRF, K.RC_CQP, None),
    "rc_pergop": (0, 0, 1, None),
    "kbps": (0, 0, 2**31 - 1, _to_bps),
    "minqstep": (K.user_qual_to_rc_qual(1) // 2, 1, K.RC_QUAL_MAX, None),
    "maxqstep": (K.user_qual_to_rc_qual(1) // 4, 1, K.RC_QUAL_MAX, None),
    "minqp": (-1 * K.RC_QUAL_SCALE, -1, 100, _pct_to_qual),
    "maxqp": (-1 * K.RC_QUAL_SCALE, -1, 100, _pct_to_qual),
    "iminqp": (-1 * K.RC_QUAL_SCALE, -1, 100, _pct_to_qual),
    "stabref": (0, 0, 2**31 - 1, None),
    "scd": (1, 0, 1, None),
    "tempaq": (1, 0, 1, None),
    "bszx": (-1, -1, 1, None),
    "bszy": (-1, -1, 1, None),
    "scpct": (85, 0, 100, None),
    "skipthresh": (0, -1, 2**31 - 1, None),
    "varint": (1, 0, 1, None),
    "psy": (K.PSY_ALL, 0, K.PSY_ALL, None),
    "dib": (1, 0, 1, None),
    "y4m": (0, 0, 1, None),
    "ifilter": (1, 0, 1, None),
    "pfilter": (-1, -1, 1, None),
    "psharp": (1, 0, 1, None),
}

DEC_PARAMS = {
    "out420p": (0, 0, 1, None),
    "y4m": (0, 0, 1, None),
    "postsharp": (0, 0, 1, None),
    "drawinfo": (0, 0, 7, None),
}


def parse_args(argv, table):
    opts = {k: v[0] for k, v in table.items()}
    io = {"inp": "-", "out": "-", "verbose": False, "overwrite": False}
    for arg in argv:
        if arg == "-v":
            io["verbose"] = True
            continue
        if arg == "-y":
            io["overwrite"] = True
            continue
        if (arg.startswith("-l") and "=" not in arg and arg[2:].isdigit()):
            from .utils import log
            log.set_level(int(arg[2:]))
            continue
        if not arg.startswith("-") or "=" not in arg:
            raise SystemExit("strange argument: %s" % arg)
        name, val = arg[1:].split("=", 1)
        if name in ("inp", "out"):
            io[name] = val
            continue
        if name not in table:
            raise SystemExit("unrecognized argument: %s" % name)
        default, lo, hi, conv = table[name]
        v = int(val)
        v = max(lo, min(hi, v))
        opts[name] = conv(v) if conv else v
    return opts, io


def confirm_overwrite(io):
    """Prompt before clobbering an existing output file unless -y was
    given (ref: dsv_main.c:368-385). Returns False to abort."""
    import os
    path = io["out"]
    if io["overwrite"] or path == "-" or not os.path.exists(path):
        return True
    while True:
        print("\n--- file (%s) already exists, overwrite? (y/n)" % path,
              flush=True)
        line = sys.stdin.readline()
        if not line:
            return False  # EOF: abort rather than loop forever
        c = line.strip()[:1]
        if c in ("y", "Y"):
            return True
        if c in ("n", "N"):
            return False


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
    from .codec import rc
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


def default_enc_opts(**overrides):
    """CLI-default encoder options (the -flag defaults), overridable."""
    opts = {k: v[0] for k, v in ENC_PARAMS.items()}
    for k, v in overrides.items():
        default, lo, hi, conv = ENC_PARAMS[k]
        v = max(lo, min(hi, int(v)))
        opts[k] = conv(v) if conv else v
    return opts



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


def print_stats(enc, total_bytes, total_frames, fps):
    """End-of-run statistics dump (ref: dsv_main.c:805-893)."""
    st = enc.stats
    total_frames = max(total_frames, 1)
    bpf = total_bytes * 8 // total_frames
    bps = bpf * fps
    print(f"encoded {total_bytes} bytes @ {bps} bps, {bps // 1024} kbps, "
          f"{bps // 8192} KBps. fps = {fps}, bpf = {bpf}", file=sys.stderr)
    if st.inum:
        print(f"num I (filt/total): {st.ifnum}/{st.inum}, total bytes: "
              f"{st.isize}, [min,avg,max] -> qual: [{st.iminq}, "
              f"{st.iqual // st.inum}, {st.imaxq}], bytes: [{st.imins}, "
              f"{st.isize // st.inum}, {st.imaxs}]", file=sys.stderr)
    if st.pnum:
        print(f"num P (filt/total): {st.pfnum}/{st.pnum}, total bytes: "
              f"{st.psize}, [min,avg,max] -> qual: [{st.pminq}, "
              f"{st.pqual // st.pnum}, {st.pmaxq}], bytes: [{st.pmins}, "
              f"{st.psize // st.pnum}, {st.pmaxs}]", file=sys.stderr)
        if st.mb:
            for name, v in (("intra", st.mbI), ("inter", st.mbP),
                            ("eprm", st.eprm), ("skip", st.skip)):
                t = v * 1000 // st.mb
                print(f"avg {name} blocks: {t // 10}.{t % 10}%",
                      file=sys.stderr)
        if st.mbP:
            for axis, fp, hp, qp in (("x", st.fpx, st.hpx, st.qpx),
                                     ("y", st.fpy, st.hpy, st.qpy)):
                f_, h_, q_ = (v * 1000 // st.mbP for v in (fp, hp, qp))
                print(f"{axis}: fp {f_ / 10:.1f}% hp {h_ / 10:.1f}% "
                      f"qp {q_ / 10:.1f}%", file=sys.stderr)


def im_clamp(v):
    return max(0, min(K.RC_QUAL_MAX, v))


def cmd_decode(argv):
    """`d`: decode a .dsv stream to y4m (-y4m=1) or raw planes, with the
    reference CLI's -out420p, -postsharp and -drawinfo options."""
    import numpy as np

    from . import native
    from .codec import decoder as D
    from .utils import chroma as chconv

    opts, io = parse_args(argv, DEC_PARAMS)
    if not confirm_overwrite(io):
        return 1
    inp = sys.stdin.buffer if io["inp"] == "-" else open(io["inp"], "rb")
    out = sys.stdout.buffer if io["out"] == "-" else open(io["out"], "wb")
    dec = D.Decoder(draw_info=opts["drawinfo"])
    writer = None
    # meta comes WITH each frame: a mid-stream PT_META packet must not
    # retag earlier frames
    for fno, meta, frame in D.decode_stream_chunked(inp, decoder=dec):
        planes = [frame.view(c) for c in range(3)]
        subs = meta.subsamp
        if opts["out420p"] and subs != K.SUBSAMP_420:
            planes = chconv.to_420(planes, subs)
            subs = K.SUBSAMP_420
        if opts["postsharp"]:
            y = np.ascontiguousarray(planes[0])
            native.post_process(y)
            planes = [y, planes[1], planes[2]]
        if writer is None:
            if opts["y4m"]:
                writer = y4m.Y4MWriter(out, meta.width, meta.height, subs,
                                       (meta.fps_num, meta.fps_den),
                                       (meta.aspect_num, meta.aspect_den))
            else:
                writer = y4m.RawYUVWriter(out)
        writer.write_frame(planes)
    if io["out"] != "-":
        out.close()
    if inp is not sys.stdin.buffer:
        inp.close()
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in ("e", "d"):
        print("usage: dsv2_tpu_torch <e|d> [options]")
        return 0
    if argv[0] == "d":
        return cmd_decode(argv[1:])
    return cmd_encode(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
