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
tests/golden/<key>.dsv, since the port cannot encode P frames yet. The
port's tests and chip_smoke.py compare against these files; the machine
with the GPU has no JAX.

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
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_streams.json")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SYNTH_DIR = os.path.join(REPO, "build", "torch_port")
FHD = "fhd1920x1080_420_32f"
FHD_SHAPE = (1920, 1080, 32)
# (name, qp, gop, frames) of the committed P streams
P_CASES = [("tiny64x48_422_4f", 60, 4, 4), ("cif352x288_420_12f", 60, 12, 12),
           (FHD, 60, 8, 8)]


def cases():
    """(name, qp) of every intra golden entry, smallest inputs first."""
    fx = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".y4m"))
    fx.sort(key=lambda n: os.path.getsize(input_path(n)))
    return ([(n, 60) for n in fx] + [("tiny64x48_444_4f", 100)]
            + [(FHD, 60)])


def key(name, qp, gop=0):
    if gop:
        return "%s@qp%d_gop%d" % (name, qp, gop)
    return "%s@qp%d" % (name, qp)


def p_key(case):
    name, qp, gop, _ = case
    return key(name, qp, gop)


def stream_path(k):
    """The committed stream of a P case."""
    return os.path.join(REPO, "tests", "golden", k + ".dsv")


def read_stream(k):
    with open(stream_path(k), "rb") as f:
        return f.read()


def input_path(name):
    """The y4m for a case; the synthetic FHD input is generated (seeded)
    under build/ on first use."""
    if name != FHD:
        return os.path.join(FIXTURES, name + ".y4m")
    path = os.path.join(SYNTH_DIR, name + ".y4m")
    if not os.path.exists(path):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import mkfixtures
        os.makedirs(SYNTH_DIR, exist_ok=True)
        tmp = path + ".%d.tmp" % os.getpid()
        mkfixtures.write_y4m(tmp, *FHD_SHAPE)
        os.replace(tmp, path)
    return path


def encode(cli, frames, meta, qp, batch=None, chunk=16, gop=0, **enc_kw):
    """The -qp=<qp> -gop=<gop> stream of `frames` through a CLI module's
    make_encoder (dsv2_tpu.cli or dsv2_tpu_torch.cli): sequential
    encode_frame calls, or the batched path if `batch` (an
    encode_intra_batch) is given."""
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=qp, gop=gop),
                           **enc_kw)
    out = []
    if batch is None:
        for fr in frames:
            out.extend(enc.encode_frame(fr))
    else:
        out.extend(batch(enc, frames, chunk=chunk))
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
    todo = [(n, q, 0, None) for n, q in cases()] + P_CASES
    for name, qp, gop, nfr in todo:
        k = key(name, qp, gop)
        if args.only and k not in args.only:
            continue
        frames, meta = read_y4m(input_path(name))
        frames = frames[:nfr]
        data = encode(cli, frames, meta, qp, gop=gop)
        entry = digest(data)
        entry.update(input=os.path.relpath(input_path(name), REPO)
                     if name != FHD else "synthetic %dx%d %d frames "
                     "(tools/mkfixtures.write_y4m)" % FHD_SHAPE,
                     args="-qp=%d -gop=%d" % (qp, gop))
        if gop:
            entry.update(frames=len(frames),
                         stream=os.path.relpath(stream_path(k), REPO))
            with open(stream_path(k), "wb") as f:
                f.write(data)
        entry["decode"] = digest(decoded_y4m(decoder, y4m, data))
        table[k] = entry
        print(k, entry["length"], entry["sha256"], entry["decode"],
              flush=True)
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        with open(GOLDEN, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
