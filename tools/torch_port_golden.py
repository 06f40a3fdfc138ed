#!/usr/bin/env python
"""Golden stream and decode digests for the torch port (dsv2_tpu_torch).

Writes tests/golden/torch_port_streams.json: for each case the port is
held to, the SHA-256 and length of the stream `dsv2_tpu` (JAX on the
CPU) encodes and ("decode") of the y4m `dsv2_tpu` decodes from it
(`dsv2 d -y4m=1`). The intra cases are every tests/fixtures/*.y4m at
-qp=60 -gop=0, tiny64x48_444_4f at -qp=100 (lossless; exercises the
per-plane contract fallback), and the synthetic FHD 1920x1080 4:2:0
32-frame input of the benchmark headline (tools/mkfixtures.write_y4m,
seeded). The P cases (P_CASES: tiny 4:2:2 at -gop=4, CIF at -gop=12, the
first 8 FHD frames at -gop=8) also commit their streams as
tests/golden/<key>.dsv (the decoder's inputs); P_DIGESTS are P cases
kept as digests only (nano and odd 4:2:0, lossless 4:4:4, nano at
-effort=5). LOCKSTEP is the lockstep P cell (BASELINE config 1, as
bench.p_lockstep cuts it): the synthetic CIF 352x288 4:2:0 384-frame
clip cut into 8 streams of 48 frames at -qp=60 -gop=48; each lane's entry
is the digest of `dsv2_tpu`'s sequential encode of its frames with no
end-of-stream packet, which is that lane's lockstep output, and
("decode") the digest of the y4m `dsv2_tpu` decodes from that stream
with an end-of-stream packet appended. GOPS are two small multi-GOP
streams (tiny64x48_420_6f at -qp=60 -gop=2, 3 GOPs, its stream
committed; the committed CIF CRF stream below, 2 GOPs with dense scans):
each entry under "gops" holds the packet count of every GOP
`dsv2_tpu.parallel.gop.split_gop_packets` finds and the digest of every
frame `dsv2_tpu.parallel.gop.decode_gops_parallel` decodes, and the tiny
one the digest of `dsv2_tpu.parallel.gop.encode_gops_parallel`'s stream
(a fresh encoder per GOP, which the committed single-encoder stream is
not). DENSE_CASES
are streams with planes whose scans the decoder's compact upload cannot
carry (more than 64 high-band values outside int8): CIF at the CLI's
default CRF with -gop=6, CIF at -qp=85 (both streams committed) and 3
FHD frames at -qp=90 -gop=0 (digests only). CORRUPT: the committed CIF
CRF stream with 8 trials of seeded byte flips (tests/test_robustness.py's
scheme: default_rng(7), 6 flips a trial at offsets from 64), each with
the digest of every frame `dsv2_tpu` decodes from it, of its y4m, the
error it raises (none do), and its corrupt P and intra planes.
ARENA_CASES: the degenerate geometries of tests/test_edge_dims.py (4
seeded synthetic frames at -qp=60 -gop=2), whose decode threads the
reference's transform scratch (the decoder arena); their decodes are
cross-checked with `dsv2_tpu/conformance/d28dec.py`. HOST_HME: the CIF
fixture at -qp=60 -gop=6, 8 frames, through `dsv2_tpu`'s host motion
search. The port's
tests and chip_smoke.py compare against these files; the machine with
the GPU has no JAX.

    python tools/torch_port_golden.py [--only KEY ...]

The helpers below (inputs, stream encoding and decoding, digests)
import no JAX and are shared with the tests and chip_smoke.py; frames
are read by the port's `dsv2_tpu_torch.cli.read_y4m`.
"""
import argparse
import hashlib
import io
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_streams.json")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SYNTH_DIR = os.path.join(REPO, "build", "torch_port")
FHD = "fhd1920x1080_420_32f"
FHD_SHAPE = (1920, 1080, 32)
CIF_LS = "cif352x288_420_384f"
# seeded synthetic inputs (tools/mkfixtures.write_y4m): name -> (w, h, frames)
SYNTH = {FHD: FHD_SHAPE, CIF_LS: (352, 288, 384)}
# (name, qp, gop, lanes, frames per lane) of the lockstep P cell
LOCKSTEP = (CIF_LS, 60, 48, 8, 48)
# (name, qp or None for the CLI's default CRF, gop) of the multi-GOP
# streams held under "gops" (both committed under tests/golden/)
GOPS = [("tiny64x48_420_6f", 60, 2), ("cif352x288_420_12f", None, 6)]
# (name, qp, gop, frames) of the committed P streams
P_CASES = [("tiny64x48_422_4f", 60, 4, 4), ("cif352x288_420_12f", 60, 12, 12),
           (FHD, 60, 8, 8)]
# (name, qp, gop, frames, effort or None) of the digest-only P cases
P_DIGESTS = [("nano48x32_420_4f", 60, 4, 4, None),
             ("odd100x62_420_4f", 60, 4, 4, None),
             ("tiny64x48_444_4f", 100, 4, 4, None),
             ("nano48x32_420_4f", 60, 4, 4, 5)]
# (name, qp or None for the CLI's default CRF, gop, frames) of the streams
# that need the decoder's dense scan upload; the CIF streams are committed
DENSE_CASES = [("cif352x288_420_12f", None, 6, 8),
               ("cif352x288_420_12f", 85, 0, 3), (FHD, 90, 0, 3)]
# the corrupt-stream trials: base stream and the byte-flip scheme
CORRUPT = dict(stream="cif352x288_420_12f@crf_gop6", seed=7, trials=8,
               flips=6, start=64)
# (name, qp, gop) of the degenerate geometries: 352x16 4:2:0 (1-px sub
# heights), 16x240 4:2:0 (1-px sub widths), 64x500 4:1:1 (chroma first)
ARENA_CASES = [("synth352x16_420_4f", 60, 2), ("synth16x240_420_4f", 60, 2),
               ("synth64x500_411_4f", 60, 2)]
# (name, qp, gop, frames, hme backend) of the host motion search encode
HOST_HME = ("cif352x288_420_12f", 60, 6, 8, "host")
# (name, qp or None for the CLI's default CRF, gop, chunk) of the batched
# intra encodes at gop != 0 (encode_intra_batch: every frame intra, a
# metadata packet at each GOP start; chunk boundaries inside GOPs)
BATCH_GOP = [("tiny64x48_420_6f", 60, 2, 3), ("cif352x288_420_12f", None, 6, 4)]
# BASELINE configs 3-5 as chip_smoke.py phases: phase -> (name, qp or None
# for the CLI's default CRF, gop, frames, effort or None, chunk of
# encode_intra_batch or None for sequential encode_frame)
CONFIGS = {
    "fhd_lossless444_intra": ("synth1920x1080_444_8f", 100, 0, 8, None, 4),
    "cif_crf_gop60_effort10": (CIF_LS, None, 60, 60, 10, None),
    "hd720_gop250": ("synth1280x720_420_16f", None, 250, 16, None, None),
}
# the CLI flag sweep: every case of tests/test_sweep.py's SWEEP (fixture,
# CLI arguments), then each encoder flag SWEEP leaves out at a
# non-default value on tiny64x48_420_6f -qp=60 -gop=48
_TINY = ["-qp=60", "-gop=48"]
SWEEP = [
    ("tiny64x48_420_6f", ["-gop=48", "-rc_mode=1", "-kbps=300"]),
    ("tiny64x48_420_6f", ["-gop=3", "-rc_mode=1", "-kbps=180",
                          "-rc_pergop=1"]),
    ("qcif176x144_420_10f", ["-gop=48", "-rc_mode=1", "-kbps=600"]),
    ("tiny64x48_444_4f", _TINY),
    ("tiny64x48_411_4f", _TINY),
    ("tiny64x48_410_4f", _TINY),
    ("qcif176x144_420_10f", _TINY),
    ("qcif176x144_420_10f", _TINY + ["-scd=0"]),
    ("tiny64x48_420_6f", _TINY + ["-tempaq=0"]),
    ("tiny64x48_420_6f", _TINY + ["-stabref=2"]),
    ("tiny64x48_420_6f", _TINY + ["-bszx=0", "-bszy=0"]),
    ("tiny64x48_420_6f", _TINY + ["-bszx=1", "-bszy=0"]),
    ("tiny64x48_420_6f", _TINY + ["-effort=0"]),
    ("tiny64x48_420_6f", _TINY + ["-effort=3"]),
    ("tiny64x48_420_6f", _TINY + ["-effort=10"]),
    ("tiny64x48_420_6f", ["-qp=100", "-gop=48", "-effort=10"]),
    ("qcif176x144_420_10f", _TINY + ["-varint=0", "-ipct=50"]),
] + [("tiny64x48_420_6f", _TINY + extra) for extra in (
    ["-psy=0"], ["-ifilter=0"], ["-pfilter=0"], ["-psharp=0"], ["-dib=0"],
    ["-pyrlevels=2"], ["-skipthresh=100"], ["-scpct=50"],
    ["-minqp=40", "-maxqp=70"], ["-iminqp=50"],
    ["-minqstep=100", "-maxqstep=200"])]
# raw packed UYVY input (tests/test_sweep.py's test_cli_sweep_uyvy): the
# frames of tiny64x48_422_4f packed as UYVY, no y4m header
UYVY = ("tiny64x48_422_4f", ["-qp=60", "-gop=48", "-fmt=5", "-w=64",
                             "-h=48"])
# lockstep lanes through the gang motion search: (fixture, lanes, CLI
# arguments); each lane's golden is dsv2_tpu's sequential encode of its
# frames (the fixture's frames cut into `lanes` equal parts), no EOS
GANG = [("tiny64x48_420_6f", 2, args) for args in (
    _TINY + ["-effort=3"], ["-qp=100", "-gop=48"],
    _TINY + ["-bszx=1", "-bszy=0"], ["-gop=48", "-rc_mode=1", "-kbps=300"])]


def cases():
    """(name, qp) of every intra golden entry, smallest inputs first."""
    fx = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".y4m"))
    fx.sort(key=lambda n: os.path.getsize(input_path(n)))
    return ([(n, 60) for n in fx] + [("tiny64x48_444_4f", 100)]
            + [(FHD, 60)])


def key(name, qp, gop=0, effort=None):
    k = "%s@%s" % (name, "crf" if qp is None else "qp%d" % qp)
    if gop:
        k += "_gop%d" % gop
    if effort is not None:
        k += "_effort%d" % effort
    return k


def config_key(phase):
    """Key of a CONFIGS entry."""
    name, qp, gop, _, effort, chunk = CONFIGS[phase]
    return key(name, qp, gop, effort) + ("" if chunk is None else "_batch")


def batch_key(case):
    """Key of a BATCH_GOP entry."""
    return key(*case[:3]) + "_batch"


def sweep_key(name, args):
    """Key of a SWEEP (or the UYVY) case: the input and its CLI
    arguments."""
    return "cli:%s %s" % (name, " ".join(args))


def gang_key(name, args, lane):
    """Key of lane `lane` of a GANG case."""
    return "gang:%s %s lane%d" % (name, " ".join(args), lane)


def cli_opts(cli, args):
    """A CLI module's encoder options for `args` ("-name=value" strings),
    as its argument parser sets them."""
    return cli.default_enc_opts(**{a[1:].split("=")[0]: int(a.split("=")[1])
                                   for a in args})


def uyvy_input(path, name):
    """Write the frames of y4m input `name` packed as UYVY (U Y V Y, no
    header; 4:2:2) to `path`."""
    import numpy as np
    from dsv2_tpu_torch.cli import read_y4m
    frames, _ = read_y4m(input_path(name))
    with open(path, "wb") as f:
        for yp, up, vp in frames:
            h, w = yp.shape
            packed = np.empty((h, w * 2), dtype=np.uint8)
            packed[:, 0::4] = up
            packed[:, 1::2] = yp
            packed[:, 2::4] = vp
            f.write(packed.tobytes())


def sweep_cases():
    """(key, input name, CLI arguments) of every SWEEP case and the UYVY
    case (its input "<y4m name>.uyvy")."""
    return [(sweep_key(n, a), n, a) for n, a in
            SWEEP + [(UYVY[0] + ".uyvy", UYVY[1])]]


def cli_encode(cli, name, args, out):
    """The stream a CLI module's `e` writes for input `name` (raw UYVY
    for a ".uyvy" name, else y4m) and `args` (in process; `out` is the
    file it writes)."""
    raw = name.endswith(".uyvy")
    rc = cli.main(["e", "-y", "-inp=" + input_path(name), "-out=" + out]
                  + ([] if raw else ["-y4m=1"]) + list(args))
    assert rc in (None, 0), (name, args, rc)
    with open(out, "rb") as f:
        return f.read()


def gang_lanes(name, nlanes):
    """(frames of each lane, meta) of a GANG case."""
    from dsv2_tpu_torch.cli import read_y4m
    frames, meta = read_y4m(input_path(name))
    per = len(frames) // nlanes
    return [frames[i * per:(i + 1) * per] for i in range(nlanes)], meta


def corrupt_key(i):
    """Key of corrupt-stream trial i."""
    return "%s_corrupt%d" % (CORRUPT["stream"], i)


def corrupt_streams(data=None):
    """The CORRUPT trials of stream `data` (default: the committed base
    stream), in trial order: each flips `flips` bytes at seeded offsets
    from `start` on, one generator over all trials."""
    import numpy as np
    if data is None:
        data = read_stream(CORRUPT["stream"])
    rng = np.random.default_rng(CORRUPT["seed"])
    out = []
    for _ in range(CORRUPT["trials"]):
        buf = bytearray(data)
        for _ in range(CORRUPT["flips"]):
            pos = int(rng.integers(CORRUPT["start"], len(buf)))
            buf[pos] ^= int(rng.integers(1, 256))
        out.append(bytes(buf))
    return out


def count_bad_planes(dec):
    """Wrap a decoder's parse_packet (dsv2_tpu's or the port's) to count
    the corrupt planes of the pictures it parses; returns the live
    counts {"p": ..., "intra": ...}."""
    counts = {"p": 0, "intra": 0}
    parse = dec.parse_packet

    def counted(buf):
        code, job, fno = parse(buf)
        if job is not None:
            counts["p" if job["has_ref"] else "intra"] += len(
                job["bad_planes"])
        return code, job, fno
    dec.parse_packet = counted
    return counts


def decode_frames(decoder_mod, y4m_mod, data, decoder=None):
    """Decode `data` as decoded_y4m does, but keep going only as far as
    the decoder does: returns dict(frames=[[fno, SHA-256 of the visible
    planes], ...], decode=the y4m's digest, error=the class name of the
    exception that ended the decode, or None)."""
    out = io.BytesIO()
    writer, frames, error = None, [], None
    try:
        for fno, meta, frame in decoder_mod.decode_stream_chunked(
                io.BytesIO(data), decoder=decoder):
            if writer is None:
                writer = y4m_mod.Y4MWriter(
                    out, meta.width, meta.height, meta.subsamp,
                    (meta.fps_num, meta.fps_den),
                    (meta.aspect_num, meta.aspect_den))
            writer.write_frame([frame.view(c) for c in range(3)])
            frames.append([int(fno),
                           hashlib.sha256(frame.tobytes()).hexdigest()])
    except Exception as exc:   # recorded: the port must fail alike
        error = type(exc).__name__
    return dict(frames=frames, decode=digest(out.getvalue()), error=error)


def p_key(case):
    """Key of a P_CASES, P_DIGESTS or DENSE_CASES entry."""
    return key(case[0], case[1], case[2], *case[4:])


def lane_key(i):
    """Key of lane i of the lockstep cell."""
    name, qp, gop = LOCKSTEP[:3]
    return key(name, qp, gop) + "_lane%d" % i


def gops_streams():
    """(key, stream bytes) of every GOPS entry, from tests/golden/."""
    return [(key(*g), read_stream(key(*g))) for g in GOPS]


def lane_frames(frames, i, nfr=None):
    """The frames of lockstep lane i (its first `nfr` if given)."""
    per = LOCKSTEP[4]
    return frames[i * per:i * per + (per if nfr is None else nfr)]


def stream_path(k):
    """The committed stream of a P case."""
    return os.path.join(REPO, "tests", "golden", k + ".dsv")


def read_stream(k):
    with open(stream_path(k), "rb") as f:
        return f.read()


def input_path(name):
    """The y4m for a case; a synthetic input (SYNTH, or
    "synth<w>x<h>_<subs>[_<n>f]": n frames of synth_input, 2 by default)
    or "<name>.uyvy" (uyvy_input of y4m input <name>) is generated
    (seeded) under build/ on first use."""
    if name.endswith(".uyvy"):
        path = os.path.join(SYNTH_DIR, name)
        if not os.path.exists(path):
            os.makedirs(SYNTH_DIR, exist_ok=True)
            tmp = path + ".%d.tmp" % os.getpid()
            uyvy_input(tmp, name[:-len(".uyvy")])
            os.replace(tmp, path)
        return path
    m = re.fullmatch(r"synth(\d+)x(\d+)_(\d+)(?:_(\d+)f)?", name)
    if m:
        return synth_input(int(m[1]), int(m[2]), m[3], int(m[4] or 2))
    if name not in SYNTH:
        return os.path.join(FIXTURES, name + ".y4m")
    path = os.path.join(SYNTH_DIR, name + ".y4m")
    if not os.path.exists(path):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import mkfixtures
        os.makedirs(SYNTH_DIR, exist_ok=True)
        tmp = path + ".%d.tmp" % os.getpid()
        mkfixtures.write_y4m(tmp, *SYNTH[name])
        os.replace(tmp, path)
    return path


def encode(cli, frames, meta, qp, batch=None, chunk=16, gop=0, effort=None,
           eos=True, backend=None, **enc_kw):
    """The -qp=<qp> -gop=<gop> [-effort=<effort>] stream of `frames`
    through a CLI module's make_encoder (dsv2_tpu.cli or
    dsv2_tpu_torch.cli), the CLI's default CRF for qp None: sequential
    encode_frame calls, or the batched path if `batch` (an
    encode_intra_batch) is given; with eos=False without the
    end-of-stream packet (a lockstep lane's bytes); `backend` sets the
    encoder's hme_backend."""
    opts = dict(gop=gop) if qp is None else dict(qp=qp, gop=gop)
    if effort is not None:
        opts["effort"] = effort
    enc = cli.make_encoder(meta, cli.default_enc_opts(**opts), **enc_kw)
    if backend is not None:
        enc.hme_backend = backend
    out = []
    if batch is None:
        for fr in frames:
            out.extend(enc.encode_frame(fr))
    else:
        out.extend(batch(enc, frames, chunk=chunk))
    if eos:
        out.extend(enc.end_of_stream())
    return b"".join(out)


def decoded_y4m(decoder_mod, y4m_mod, data, decoder=None):
    """The y4m that `d -y4m=1` writes for stream `data`, through a decoder
    module's decode_stream_chunked (dsv2_tpu.codec.decoder or
    dsv2_tpu_torch.codec.decoder) and the matching y4m module."""
    out = io.BytesIO()
    writer = None
    for _, meta, frame in decoder_mod.decode_stream_chunked(
            io.BytesIO(data), decoder=decoder):
        if writer is None:
            writer = y4m_mod.Y4MWriter(out, meta.width, meta.height,
                                       meta.subsamp,
                                       (meta.fps_num, meta.fps_den),
                                       (meta.aspect_num, meta.aspect_den))
        writer.write_frame([frame.view(c) for c in range(3)])
    return out.getvalue()


def hme_case(frames, meta, has_tmv=False, effort=10, quant=1200,
             shift=(3, 2), seed=0, skip_thresh=0, device="cpu", blk=None,
             lossless=False):
    """Seeded inputs of the port's motion search (the arguments of
    dsv2_tpu_torch.ops.hme_wave.make_motion_est) built from the first
    frame of `frames`: the source is that frame shifted by `shift` with
    noise, the reference a noised copy of it (the "recon"), the original
    reference the frame itself; one block of the source is a copy of the
    reference (skip) and one a flat patch (intra), so the refine, subpel,
    skip, intra and EPRM branches fire. Blocks are the encoder's size for
    the frame unless `blk` is given (a size, or (width, height) as
    -bszx/-bszy force them). Returns (WaveCfg field dict, inputs tuple)
    with the planes as tensors on `device`."""
    import numpy as np
    import torch
    from dsv2_tpu_torch.core import constants as K
    from dsv2_tpu_torch.core import intmath as im
    from dsv2_tpu_torch.core.frame import plane_dims
    from dsv2_tpu_torch.ops import framedev

    rng = np.random.RandomState(seed)
    f0 = [p.astype(np.int32) for p in frames[0]]
    w, h, sub = meta.width, meta.height, meta.subsamp
    hs, vs = K.fmt_h_shift(sub), K.fmt_v_shift(sub)

    def noisy(pl, dx, dy, noise):
        s = (np.roll(np.roll(pl, dy, 0), dx, 1)
             + rng.randint(-noise, noise + 1, pl.shape))
        return np.clip(s, 0, 255).astype(np.uint8)

    cs = [(shift[0], shift[1]), (shift[0] >> hs, shift[1] >> vs)]
    src = [noisy(f0[c], *cs[min(c, 1)], 3 if c == 0 else 2) for c in range(3)]
    ref = [noisy(f0[c], 0, 0, 2) for c in range(3)]
    ogr = [f0[c].astype(np.uint8) for c in range(3)]
    if blk is None:
        blk = K.MAX_BLOCK_SIZE if min(w, h) > 1280 else K.MIN_BLOCK_SIZE
    bw, bh = (blk, blk) if isinstance(blk, int) else blk
    src[0][:bh, :bw] = ref[0][:bh, :bw]
    src[0][bh:2 * bh, bw:bw + bw // 2] = 200
    nbh, nbv = -(-w // bw), -(-h // bh)
    lvls = im.lb2(min(w, h))
    while (1 << lvls) > max(nbh, nbv):
        lvls -= 1
    lvls = im.clamp(lvls, 3, K.MAX_PYRAMID_LEVELS)
    dims = plane_dims(sub, w, h)
    dev = torch.device(device)

    def chain(planes):
        b = [framedev.extend_plane_graph(torch.as_tensor(p).to(dev), *dims[c])
             for c, p in enumerate(planes)]
        return b, [b[0]] + framedev.pyramid_graph(b[0], w, h, lvls)

    (sb, sp), (rb, rp), (_, op) = chain(src), chain(ref), chain(ogr)
    if has_tmv:
        tmv = rng.randint(-24, 25, (2, nbv, nbh)).astype(np.int32)
    else:
        tmv = np.zeros((2, nbv, nbh), np.int32)
    tmv = torch.as_tensor(tmv).to(dev)
    cfg = dict(nbh=nbh, nbv=nbv, blk_w=bw, blk_h=bh, vid_w=w, vid_h=h,
               subsamp=sub, effort=effort, lossless=lossless,
               pyramid_levels=lvls, has_tmv=has_tmv,
               skip_thresh_neg=skip_thresh < 0,
               dims=tuple([(w, h)] + [(im.round_shift(w, i + 1),
                                       im.round_shift(h, i + 1))
                                      for i in range(lvls)]))
    inputs = (tuple(sp), tuple(rp), tuple(op), sb[1], sb[2], rb[1], rb[2],
              tmv[0], tmv[1], quant, skip_thresh)
    return cfg, inputs


def synth_input(w, h, subs, nframes):
    """A seeded synthetic y4m (tools/mkfixtures.write_y4m) of w x h in
    chroma format `subs` ("420", "411", ...), generated under build/ on
    first use; returns its path."""
    path = os.path.join(SYNTH_DIR, "synth%dx%d_%s_%df.y4m"
                        % (w, h, subs, nframes))
    if not os.path.exists(path):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import mkfixtures
        os.makedirs(SYNTH_DIR, exist_ok=True)
        tmp = path + ".%d.tmp" % os.getpid()
        mkfixtures.write_y4m(tmp, w, h, nframes, subs=subs)
        os.replace(tmp, path)
    return path


def hme_lanes(frames, meta, n, has_tmv=False, effort=10, device="cpu",
              quant=None, **kw):
    """(WaveCfg field dict, [inputs of lane 0..n-1]): hme_case inputs of n
    lockstep lanes sharing one WaveCfg, each lane from another frame,
    shift, noise seed and quant (`quant` for every lane if given); `kw`
    go to hme_case (lossless, blk)."""
    lanes = []
    for i in range(n):
        cfg, inputs = hme_case(frames[i % len(frames):], meta,
                               has_tmv=has_tmv, effort=effort,
                               quant=600 + 170 * i if quant is None else quant,
                               shift=(3 - i % 5, 2 - i % 3), seed=i,
                               device=device, **kw)
        lanes.append(inputs)
    return cfg, lanes


VK_KINDS = ("random", "constant", "climb", "zero_runs", "edges")


def vk_case(kind, nb, npad=4096, seed=0):
    """Seeded vk chain inputs (thr (npad, nb), s0 (nb,), nnz (nb,) int32
    numpy) of one adversarial kind: random (thr in [0, 60), 40% zeros);
    constant thr per chain (vk oscillates, in both parities); climb (thr
    far above any vk: no speculative candidate ever meets the truth);
    zero_runs (runs of thr = 0, where the clamp at vk = 0 flips a
    trajectory's parity); edges (random thr; chain 0 spans every row,
    chain 1 has s0 > nnz, chain 2 an empty range, the rest start and end
    at chunk boundaries +-1 of chunks 64..2048 and warm-ups 0..512, or
    out of range)."""
    import numpy as np
    rng = np.random.default_rng(seed * 1000 + 10 * VK_KINDS.index(kind) + nb)
    s0 = rng.integers(0, npad // 4, nb)
    nnz = np.maximum(s0, rng.integers(npad // 2, npad + 1, nb))
    if kind in ("random", "edges"):
        thr = rng.integers(0, 60, (npad, nb))
        thr[rng.random((npad, nb)) < 0.4] = 0
    elif kind == "constant":
        thr = np.broadcast_to(rng.integers(1, 9, nb), (npad, nb))
    elif kind == "climb":
        thr = np.full((npad, nb), 1 << 30)
    else:
        runs = rng.integers(1, 300, npad)
        zero = np.repeat(np.arange(npad) % 2, runs)[:npad] == 0
        thr = rng.integers(0, 40, (npad, nb))
        thr[zero] = 0
    if kind == "edges":
        picks = [0, 1, npad - 1, npad, npad + 9, -5]
        for m in (1, 2, 3):
            for chunk in (64, 256, 1024, 2048):
                for warm in (0, 128, 512):
                    picks += [m * chunk + warm + d for d in (-1, 0, 1)]
        picks = np.array([p for p in picks if p <= npad + 9])
        s0, nnz = rng.choice(picks, nb), rng.choice(picks, nb)
        s0[0], nnz[0] = 0, npad
        s0[1:2], nnz[1:2] = npad // 3, npad // 5
        s0[2:3], nnz[2:3] = npad // 2, npad // 2
    return tuple(np.ascontiguousarray(a, dtype=np.int32)
                 for a in (thr, s0, nnz))


def filter_case(kind, w, h, blk, shifts=(1, 1), seed=0, nb=1):
    """Seeded public-API arguments (CPU tensors) of one batched in-loop
    filter call of `kind` on nb planes: a w x h 4:4:4-sized luma geometry
    with blk x blk blocks; chroma planes and blocks shifted down by
    shifts (h, v) (the chroma format). Planes are gradients with mild
    noise and steps at 8x8 cells, the bottom third pure noise (tile
    energies in every filter's working range); motion fields hold intra,
    skip, EPRM and small-vector blocks."""
    import numpy as np
    import torch
    from dsv2_tpu_torch.core import constants as K

    rng = np.random.default_rng(seed)
    nbh, nbv = -(-w // blk), -(-h // blk)
    bw = bh = blk
    if kind == "chroma":
        w, h, bw, bh = (w >> shifts[0], h >> shifts[1], blk >> shifts[0],
                        blk >> shifts[1])
    yy, xx = np.mgrid[0:h, 0:w]
    cells = rng.integers(-24, 25, (nb, -(-h // 8), -(-w // 8)))
    steps = np.kron(cells, np.ones((1, 8, 8), np.int64))[:, :h, :w]
    vis = np.clip(xx // 3 + yy // 2 + 64 + steps
                  + rng.integers(-3, 4, (nb, h, w)), 0, 255)
    vis[:, 2 * h // 3:] = rng.integers(0, 256, (nb, h - 2 * h // 3, w))
    n = (nb, nbv, nbh)
    mvx, mvy = rng.integers(-40, 41, n), rng.integers(-40, 41, n)
    tiny = rng.integers(0, 3, n) == 0
    mvx[tiny] = rng.integers(-2, 3, int(tiny.sum()))
    mvy[tiny] = rng.integers(-2, 3, int(tiny.sum()))
    r = rng.integers(0, 100, n)
    flags = ((r < 20).astype(np.int64) << K.MV_BIT_INTRA
             | ((r >= 20) & (r < 40)).astype(np.int64) << K.MV_BIT_SKIP
             | (rng.integers(0, 4, n) == 0).astype(np.int64)
             << K.MV_BIT_EPRM)
    sub = rng.integers(0, 16, n)
    fq = rng.integers(600, 1600, nb)

    def t(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dt)
    vis = t(vis, torch.uint8)
    mv = (t(mvx), t(mvy), t(flags))
    if kind == "intra":
        return (w, h, nbh, nbv, vis, t(rng.integers(0, 64, n), torch.uint8),
                t(fq), t(rng.integers(100, 200, nb)))
    if kind == "luma":
        return (w, h, nbh, nbv, bw, bh, 1, vis) + mv + (
            t(sub), t(fq), t(rng.integers(100, 200, nb)), 1,
            t(rng.integers(0, 2, nb)))
    return (w, h, nbh, nbv, bw, bh, vis) + mv + (
        t(rng.integers(100, 3000, nb)),)


def filter_native(kind, args):
    """The port's native C filter (raster order, on the host) over every
    plane of a filter_case call: the expected (nb, h, w) uint8 planes."""
    import numpy as np
    import torch
    from dsv2_tpu_torch import native

    def np_(x, dt=None):
        a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return np.ascontiguousarray(a if dt is None else a.astype(dt))
    w, h, nbh, nbv = args[:4]
    if kind == "intra":
        vis, bd, fq, fth = args[4:]
    elif kind == "luma":
        bw, bh, sharpen, vis, mvx, mvy, flags, sub, fq, fth, df, tmc = \
            args[4:]
    else:
        bw, bh, vis, mvx, mvy, flags, q = args[4:]
    out = np_(vis).copy()
    for p in range(out.shape[0]):
        ref = np.ascontiguousarray(out[p])
        if kind == "intra":
            native.intra_filter(ref, w, h, w, np_(bd[p]).reshape(-1), nbh,
                                nbv, int(fq[p]), int(fth[p]), 0, 1)
        else:
            mv = [np_(a[p], dt).reshape(-1) for a, dt in
                  ((mvx, np.int16), (mvy, np.int16), (flags, np.uint32))]
            if kind == "luma":
                native.luma_filter(ref, w, h, w, *mv,
                                   np_(sub[p], np.uint8).reshape(-1), nbh,
                                   nbv, bw, bh, int(fq[p]), int(fth[p]), 0,
                                   int(df), int(tmc[p]), int(sharpen))
            else:
                native.chroma_filter(ref, w, h, w, *mv, nbh, nbv, bw, bh,
                                     int(q[p]), 0)
        out[p] = ref
    return torch.from_numpy(out)


HME_OUTPUTS = ("fx", "fy", "flags", "err", "dc", "submask", "fskip", "terr",
               "ndiff", "nelig", "nintra")


def digest(data):
    return {"sha256": hashlib.sha256(data).hexdigest(), "length": len(data)}


def load():
    with open(GOLDEN) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", help="case keys to (re)compute")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from dsv2_tpu import cli
    from dsv2_tpu.codec import decoder
    from dsv2_tpu.utils import y4m
    from dsv2_tpu_torch.cli import read_y4m

    table = load() if os.path.exists(GOLDEN) else {}
    todo = ([(n, q, 0, None, None) for n, q in cases()]
            + [c + (None,) for c in P_CASES + DENSE_CASES] + P_DIGESTS)
    name, qp, gop, lanes, per = LOCKSTEP
    todo_lanes = [i for i in range(lanes)
                  if not args.only or lane_key(i) in args.only]
    if todo_lanes:
        frames, meta = read_y4m(input_path(name))
    from dsv2_tpu.utils.packet import encode_eos
    for i in todo_lanes:
        k = lane_key(i)
        fr = lane_frames(frames, i)
        data = encode(cli, fr, meta, qp, gop=gop, eos=False)
        table[k] = dict(digest(data),
                        input="synthetic %dx%d %d frames "
                        "(tools/mkfixtures.write_y4m)" % SYNTH[name],
                        args="-qp=%d -gop=%d" % (qp, gop), lane=i,
                        frames="%d-%d" % (i * per, i * per + len(fr) - 1),
                        eos=False, decode=digest(decoded_y4m(
                            decoder, y4m, data + encode_eos())))
        print(k, table[k]["length"], table[k]["sha256"], flush=True)
        _save(table, k)
    _main_gops(args, table, cli, read_y4m)
    for name, qp, gop, nfr, effort in todo:
        k = key(name, qp, gop, effort)
        if args.only and k not in args.only:
            continue
        frames, meta = read_y4m(input_path(name))
        frames = frames[:nfr]
        data = encode(cli, frames, meta, qp, gop=gop, effort=effort)
        entry = digest(data)
        entry.update(input=os.path.relpath(input_path(name), REPO)
                     if name not in SYNTH else "synthetic %dx%d %d frames "
                     "(tools/mkfixtures.write_y4m)" % SYNTH[name],
                     args=("" if qp is None else "-qp=%d " % qp)
                     + "-gop=%d" % gop
                     + ("" if effort is None else " -effort=%d" % effort))
        if nfr is not None:
            entry["frames"] = len(frames)
        if (effort is None and name != FHD and (name, qp, gop, nfr) in
                DENSE_CASES) or (gop and effort is None
                                 and (name, qp, gop, nfr) in P_CASES):
            entry["stream"] = os.path.relpath(stream_path(k), REPO)
            with open(stream_path(k), "wb") as f:
                f.write(data)
        entry["decode"] = digest(decoded_y4m(decoder, y4m, data))
        table[k] = entry
        print(k, entry["length"], entry["sha256"], entry["decode"],
              flush=True)
        _save(table, k)
    _main_host_chain(args, table, cli, decoder, y4m, read_y4m)
    _main_surface(args, table, cli, decoder, y4m, read_y4m)


def _main_gops(args, table, cli, read_y4m):
    """The GOPS entries; the tiny stream is encoded and committed here."""
    from dsv2_tpu.parallel import gop as jgop
    gops = table.setdefault("gops", {})
    for name, qp, gop in GOPS:
        k = key(name, qp, gop)
        if args.only and k not in args.only and "gops" not in args.only:
            continue
        entry = {}
        if qp is not None:
            frames, meta = read_y4m(input_path(name))
            if not os.path.exists(stream_path(k)):
                with open(stream_path(k), "wb") as f:
                    f.write(encode(cli, frames, meta, qp, gop=gop))
            entry["encode_gops_parallel"] = digest(jgop.encode_gops_parallel(
                frames, meta, gop, lambda: cli.make_encoder(
                    meta, cli.default_enc_opts(qp=qp, gop=gop))))
        data = read_stream(k)
        frames = jgop.decode_gops_parallel(io.BytesIO(data))
        gops[k] = dict(entry, **digest(data),
                       stream=os.path.relpath(stream_path(k), REPO),
                       packets_per_gop=[len(c) for c in
                                        jgop.split_gop_packets(
                                            io.BytesIO(data))],
                       frames=[hashlib.sha256(f.tobytes()).hexdigest()
                               for f in frames])
        print(k, gops[k]["packets_per_gop"], len(frames), flush=True)
        _save(table, "gops")


def _main_host_chain(args, table, cli, decoder, y4m, read_y4m):
    """The cases of the host chains: CORRUPT, ARENA_CASES, HOST_HME."""
    from dsv2_tpu.conformance import d28dec
    for i, data in enumerate(corrupt_streams()):
        k = corrupt_key(i)
        if args.only and k not in args.only:
            continue
        dec = decoder.Decoder()
        bad = count_bad_planes(dec)
        entry = decode_frames(decoder, y4m, data, decoder=dec)
        entry.update(digest(data), bad_planes=bad, trial=i,
                     base=CORRUPT["stream"])
        table[k] = entry
        print(k, len(entry["frames"]), entry["error"], bad, flush=True)
        _save(table, k)
    for name, qp, gop in ARENA_CASES:
        k = key(name, qp, gop)
        if args.only and k not in args.only:
            continue
        frames, meta = read_y4m(input_path(name))
        data = encode(cli, frames, meta, qp, gop=gop)
        dec = decoded_y4m(decoder, y4m, data)
        tmp = os.path.join(SYNTH_DIR, "arena.%d" % os.getpid())
        with open(tmp + ".dsv", "wb") as f:
            f.write(data)
        d28dec.decode_file(tmp + ".dsv", tmp + ".y4m")
        with open(tmp + ".y4m", "rb") as f:
            assert f.read() == dec, (k, "d28dec disagrees")
        for ext in (".dsv", ".y4m"):
            os.remove(tmp + ext)
        table[k] = dict(digest(data), decode=digest(dec), d28dec=True,
                        input="synthetic (tools/mkfixtures.write_y4m)",
                        args="-qp=%d -gop=%d" % (qp, gop),
                        frames=len(frames))
        print(k, table[k]["length"], table[k]["decode"], flush=True)
        _save(table, k)
    name, qp, gop, nfr, backend = HOST_HME
    k = key(name, qp, gop)
    if not args.only or k in args.only:
        frames, meta = read_y4m(input_path(name))
        data = encode(cli, frames[:nfr], meta, qp, gop=gop, backend=backend)
        table[k] = dict(digest(data),
                        decode=digest(decoded_y4m(decoder, y4m, data)),
                        input=os.path.relpath(input_path(name), REPO),
                        args="-qp=%d -gop=%d" % (qp, gop), frames=nfr,
                        hme_backend=backend)
        print(k, table[k]["length"], table[k]["sha256"], flush=True)
        _save(table, k)


def _save(table, k):
    """Merge entry `k` of `table` into the golden file as it is on disk,
    under a lock, so that runs with distinct --only keys can run at
    once."""
    import fcntl
    os.makedirs(SYNTH_DIR, exist_ok=True)
    with open(os.path.join(SYNTH_DIR, "golden.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        disk = load() if os.path.exists(GOLDEN) else {}
        disk[k] = table[k]
        tmp = GOLDEN + ".%d.tmp" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(disk, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, GOLDEN)


def _main_surface(args, table, cli, decoder, y4m, read_y4m):
    """BATCH_GOP, CONFIGS, the sweep (SWEEP and UYVY) and GANG. --only
    also takes the group names "batch_gop", "configs", "sweep" and
    "gang", and the CONFIGS phase names."""
    from dsv2_tpu.parallel.batch import encode_intra_batch
    from dsv2_tpu.utils.packet import encode_eos

    def wanted(k, *groups):
        return not args.only or any(g in args.only for g in (k,) + groups)

    def record(k, data, **kw):
        table[k] = dict(digest(data), **kw)
        table[k].setdefault("decode", digest(decoded_y4m(decoder, y4m,
                                                         data)))
        print(k, table[k]["length"], table[k]["sha256"], flush=True)
        _save(table, k)

    for case in BATCH_GOP:
        name, qp, gop, chunk = case
        if not wanted(batch_key(case), "batch_gop"):
            continue
        frames, meta = read_y4m(input_path(name))
        data = encode(cli, frames, meta, qp, batch=encode_intra_batch,
                      chunk=chunk, gop=gop)
        record(batch_key(case), data, frames=len(frames), chunk=chunk,
               input=os.path.relpath(input_path(name), REPO),
               args=("" if qp is None else "-qp=%d " % qp) + "-gop=%d" % gop,
               path="encode_intra_batch")
    for phase, (name, qp, gop, nfr, effort, chunk) in CONFIGS.items():
        if not wanted(config_key(phase), phase, "configs"):
            continue
        frames, meta = read_y4m(input_path(name))
        frames = frames[:nfr]
        data = encode(cli, frames, meta, qp, gop=gop, effort=effort,
                      batch=None if chunk is None else encode_intra_batch,
                      chunk=chunk or 16)
        del frames
        record(config_key(phase), data, frames=nfr, phase=phase,
               chunk=chunk, input="synthetic (tools/mkfixtures.write_y4m)",
               args=("" if qp is None else "-qp=%d " % qp) + "-gop=%d" % gop
               + ("" if effort is None else " -effort=%d" % effort),
               path="encode_frame" if chunk is None else "encode_intra_batch")
    tmp = os.path.join(SYNTH_DIR, "sweep.%d.dsv" % os.getpid())
    for k, name, a in sweep_cases():
        if wanted(k, "sweep"):
            record(k, cli_encode(cli, name, a, tmp), args=" ".join(a),
                   input=os.path.relpath(input_path(name), REPO),
                   raw=name.endswith(".uyvy"))
    if os.path.exists(tmp):
        os.remove(tmp)
    for name, nlanes, a in GANG:
        lanes, meta = gang_lanes(name, nlanes)
        for i, fr in enumerate(lanes):
            k = gang_key(name, a, i)
            if not wanted(k, "gang"):
                continue
            enc = cli.make_encoder(meta, cli_opts(cli, a))
            data = b"".join(b for f in fr for b in enc.encode_frame(f))
            record(k, data, lane=i, frames=len(fr), eos=False,
                   args=" ".join(a), decode=digest(decoded_y4m(
                       decoder, y4m, data + encode_eos())))


if __name__ == "__main__":
    main()
