#!/usr/bin/env python
"""GOP-chunked parallel encode (port of tools/parallel_encode.py, the
reference's parallel_encode.sh as a tool): cuts a Y4M (or raw planar
YUV) input into closed GOPs and either

  - runs worker processes of the port's CLI, `python -m dsv2_tpu_torch
    e -sfr=S -nfr=N -noeos=1 ...`, `workers` at a time, or
  - with --lockstep, encodes every GOP stream in one process with
    lockstep device batching (parallel/dynbatch.encode_streams_lockstep,
    one group of `workers` lanes, the gang motion search): each flush
    runs the motion search, the input prep and the frame chain step once
    for all lanes.

The GOP streams are byte-concatenated with one end-of-stream packet;
both modes give the bytes of a chunked sequential encode. Raw planar YUV
(a non-.y4m input or -y4m=0) takes -w= -h= -fmt= (and -fps_num/-fps_den)
as the encoder CLI does.

    python -m dsv2_tpu_torch.tools.parallel_encode IN OUT.dsv [workers]
        [--lockstep] [encoder -flags...]

Runs on the card unless DSV2_TORCH_DEVICE=cpu (which the worker
processes inherit).
"""
import os
import subprocess
import sys
import tempfile

from .. import cli
from ..parallel.dynbatch import encode_streams_lockstep
from ..utils import y4m
from ..utils.packet import VideoMeta, encode_eos


def _is_y4m(src, extra):
    for a in extra:
        if a.startswith("-y4m="):
            return bool(int(a.split("=")[1]))
    return src.endswith(".y4m")


def _open_reader(f, src, extra):
    """(reader, VideoMeta, encoder options) from the input and the flags."""
    opts, _ = cli.parse_args(extra, cli.ENC_PARAMS)
    if _is_y4m(src, extra):
        rdr = y4m.Y4MReader(f)
        meta = VideoMeta(width=rdr.w, height=rdr.h, subsamp=rdr.subsamp,
                         fps_num=rdr.fps[0], fps_den=rdr.fps[1],
                         aspect_num=rdr.aspect[0], aspect_den=rdr.aspect[1])
    else:
        meta = VideoMeta(width=opts["w"], height=opts["h"],
                         subsamp=opts["fmt"], fps_num=opts["fps_num"],
                         fps_den=opts["fps_den"],
                         aspect_num=opts["aspect_num"],
                         aspect_den=opts["aspect_den"])
        rdr = y4m.RawYUVReader(f, meta.width, meta.height, meta.subsamp)
    return rdr, meta, opts


def lockstep_main(src, out, width, extra):
    with open(src, "rb") as f:
        rdr, meta, opts = _open_reader(f, src, extra)
        frames = []
        while True:
            p = rdr.read_frame()
            if p is None:
                break
            frames.append(p)
    gop = opts["gop"] if opts["gop"] > 0 else 48
    streams = [frames[i:i + gop] for i in range(0, len(frames), gop)]

    def factory():
        o = dict(opts, gop=gop)
        enc = cli.make_encoder(meta, o)
        enc.hme_backend = "gang"
        return enc

    parts = encode_streams_lockstep(streams, factory, width=width)
    with open(out, "wb") as f:
        for p in parts:
            f.write(p)
        f.write(encode_eos())
    print(out)
    return 0


def workers_main(src, out, workers, extra):
    gop = 48
    for a in extra:
        if a.startswith("-gop="):
            gop = int(a.split("=")[1])
    with open(src, "rb") as f:
        rdr, _, _ = _open_reader(f, src, extra)
        n = 0
        while rdr.read_frame() is not None:
            n += 1
    if gop <= 0:
        gop = n
    y4m_flag = "-y4m=%d" % int(_is_y4m(src, extra))
    ranges = [(s, min(s + gop, n)) for s in range(0, n, gop)]
    with tempfile.TemporaryDirectory(prefix="dsv2par") as tmp:
        procs, outs = [], []
        for k, (s, e) in enumerate(ranges):
            o = os.path.join(tmp, "chunk%04d.dsv" % k)
            outs.append(o)
            cmd = [sys.executable, "-m", "dsv2_tpu_torch", "e", "-y",
                   "-inp=" + src, "-out=" + o, y4m_flag, "-sfr=%d" % s,
                   "-nfr=%d" % (e - s), "-noeos=1",
                   "-gop=%d" % gop] + extra
            procs.append(subprocess.Popen(cmd))
            while len([p for p in procs if p.poll() is None]) >= workers:
                next(p for p in procs if p.poll() is None).wait()
        for p in procs:
            if p.wait() != 0:
                raise SystemExit("worker failed: %s" % " ".join(p.args))
        with open(out, "wb") as f:
            for o in outs:
                with open(o, "rb") as g:
                    f.write(g.read())
            f.write(encode_eos())
    print(out)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    src, out = argv[0], argv[1]
    rest = argv[2:]
    lockstep = "--lockstep" in rest
    rest = [a for a in rest if a != "--lockstep"]
    workers = None
    if rest and not rest[0].startswith("-"):
        workers = int(rest[0])
        rest = rest[1:]
    if lockstep:
        return lockstep_main(src, out, workers, rest)
    return workers_main(src, out, workers or os.cpu_count(), rest)


if __name__ == "__main__":
    sys.exit(main())
