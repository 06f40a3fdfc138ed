#!/usr/bin/env python
"""Golden stream digests for the torch port (dsv2_tpu_torch).

Writes tests/golden/torch_port_streams.json: the SHA-256 and length of
the stream `dsv2_tpu` (JAX on the CPU) encodes for each case the port is
held to — every tests/fixtures/*.y4m at -qp=60 -gop=0, tiny64x48_444_4f
at -qp=100 (lossless; exercises the per-plane contract fallback), and the
synthetic FHD 1920x1080 4:2:0 32-frame input of the benchmark headline
(tools/mkfixtures.write_y4m, seeded). The port's tests and chip_smoke.py
compare against this file; the machine with the GPU has no JAX.

    python tools/torch_port_golden.py [--only NAME ...]

The helpers below (inputs, stream encoding, digests) import no JAX and
are shared with the tests and chip_smoke.py; frames are read by the
port's `dsv2_tpu_torch.cli.read_y4m`.
"""
import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_streams.json")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SYNTH_DIR = os.path.join(REPO, "build", "torch_port")
FHD = "fhd1920x1080_420_32f"
FHD_SHAPE = (1920, 1080, 32)


def cases():
    """(name, qp) of every golden entry, smallest inputs first."""
    fx = sorted(f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".y4m"))
    fx.sort(key=lambda n: os.path.getsize(input_path(n)))
    return ([(n, 60) for n in fx] + [("tiny64x48_444_4f", 100)]
            + [(FHD, 60)])


def key(name, qp):
    return "%s@qp%d" % (name, qp)


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


def encode(cli, frames, meta, qp, batch=None, chunk=16, **enc_kw):
    """The -qp=<qp> -gop=0 stream of `frames` through a CLI module's
    make_encoder (dsv2_tpu.cli or dsv2_tpu_torch.cli): sequential
    encode_frame calls, or the batched path if `batch` (an
    encode_intra_batch) is given."""
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=qp, gop=0),
                           **enc_kw)
    out = []
    if batch is None:
        for fr in frames:
            out.extend(enc.encode_frame(fr))
    else:
        out.extend(batch(enc, frames, chunk=chunk))
    out.extend(enc.end_of_stream())
    return b"".join(out)


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
    from dsv2_tpu_torch.cli import read_y4m

    table = load() if os.path.exists(GOLDEN) else {}
    for name, qp in cases():
        k = key(name, qp)
        if args.only and k not in args.only:
            continue
        frames, meta = read_y4m(input_path(name))
        entry = digest(encode(cli, frames, meta, qp))
        entry.update(input=os.path.relpath(input_path(name), REPO)
                     if name != FHD else "synthetic %dx%d %d frames "
                     "(tools/mkfixtures.write_y4m)" % FHD_SHAPE,
                     args="-qp=%d -gop=0" % qp)
        table[k] = entry
        print(k, entry["length"], entry["sha256"], flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
