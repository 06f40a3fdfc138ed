"""torch port end to end on the CPU: the port's CLI and its batched
encode_intra_batch must produce the golden `dsv2_tpu` streams
(tests/golden/torch_port_streams.json, tools/torch_port_golden.py) for
every fixture, the lossless contract-fallback case included; the port's
decoder must give `dsv2_tpu`'s decoded y4m for each of those streams and
for the committed P streams (and the conformance decoder's frames), its
CLI `d` the bytes of `python -m dsv2_tpu d` under every decode option;
the smallest entries are re-derived live through dsv2_tpu; and the port
imports nothing of dsv2_tpu or jax."""
import ast
import functools
import hashlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import REPO
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m

GOLD = golden.load()
SMALL = [golden.key(n, q) for n, q in golden.cases()[:2]]
FIXTURE_CASES = [(n, q) for n, q in golden.cases() if n != golden.FHD]
P_SMALL = [golden.p_key(c) for c in golden.P_CASES if c[0] != golden.FHD]


def _check(key, data, what=None):
    want = GOLD[key] if what is None else GOLD[key][what]
    assert len(data) == want["length"], key
    assert hashlib.sha256(data).hexdigest() == want["sha256"], key


def _port_y4m(data):
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    return golden.decoded_y4m(decoder, y4m, data,
                              decoder=decoder.Decoder(device="cpu"))


@pytest.mark.parametrize("name,qp", FIXTURE_CASES,
                         ids=[golden.key(n, q) for n, q in FIXTURE_CASES])
def test_cli_golden(name, qp, tmp_path):
    from dsv2_tpu_torch.cli import main
    out = tmp_path / "out.dsv"
    assert main(["e", "-y", "-y4m=1", "-qp=%d" % qp, "-gop=0",
                 "-inp=" + golden.input_path(name), "-out=%s" % out]) == 0
    _check(golden.key(name, qp), out.read_bytes())


@functools.lru_cache(maxsize=None)
def _batch_stream(name, qp):
    """The port's batched CPU encode of an intra case (shared by the
    encode and decode tests of one worker)."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    frames, meta = read_y4m(golden.input_path(name))
    return golden.encode(cli, frames, meta, qp, batch=encode_intra_batch,
                         chunk=4, device="cpu")


@pytest.mark.parametrize("name,qp", FIXTURE_CASES,
                         ids=[golden.key(n, q) for n, q in FIXTURE_CASES])
def test_batch_golden(name, qp):
    _check(golden.key(name, qp), _batch_stream(name, qp))


@pytest.mark.parametrize("key", SMALL)
def test_golden_live(key):
    """The golden file is what dsv2_tpu encodes today, and so is the port."""
    from dsv2_tpu import cli as jcli
    from dsv2_tpu_torch import cli
    name, qp = [(n, q) for n, q in golden.cases()
                if golden.key(n, q) == key][0]
    frames, meta = read_y4m(golden.input_path(name))
    want = golden.encode(jcli, frames, meta, qp)
    _check(key, want)
    assert golden.encode(cli, frames, meta, qp, device="cpu") == want


@pytest.mark.slow
def test_golden_live_fhd():
    from dsv2_tpu import cli as jcli
    frames, meta = read_y4m(golden.input_path(golden.FHD))
    _check(golden.key(golden.FHD, 60),
           golden.encode(jcli, frames, meta, 60))


def test_stage_totals():
    """The port's trace module reads and clears the batch stage times;
    totals are the records' seconds, self time at most the seconds."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    from dsv2_tpu_torch.utils import trace
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    trace.reset()
    trace.enable(True)
    try:
        golden.encode(cli, frames, meta, 60, batch=encode_intra_batch,
                      device="cpu")
        got = trace.totals()
        tab = trace.table()
    finally:
        trace.enable(False)
    assert {"batch.prep", "batch.dispatch", "batch.fetch",
            "batch.serialize"} <= set(got)
    assert all(t > 0 for t in got.values())
    assert got == {k: v[0] for k, v in tab.items()}
    assert all(0 < v[1] <= v[0] and v[2] > 0 for v in tab.values())
    assert tab["batch.dispatch"][2] == 1 and "sync" not in tab   # CPU
    trace.reset()
    assert trace.totals() == {} and trace.records() == []


def test_p_frames_raise():
    """dsv2_tpu's "host" motion search backend is an alias of "pallas" in
    the port: the nano P stream equals dsv2_tpu's. (Named when the
    backend still raised; "pallas" and "gang" are in
    tests/test_torch_pencode.py and tests/test_torch_lockstep.py, the
    CIF "host" and "wave" encodes in tests/test_torch_hme.py.)"""
    _encodes_p("host")


def test_p_frames_raise_wave():
    """"wave" is an alias of "pallas": the same nano P stream."""
    _encodes_p("wave")


def _encodes_p(backend):
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import hme
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=4),
                           device="cpu")
    enc.hme_backend = backend
    assert hme.resolve_backend(enc) == "pallas"
    out = []
    for fr in frames:
        out.extend(enc.encode_frame(fr))
    out.extend(enc.end_of_stream())
    assert enc.stats.pnum > 0
    _check(golden.key("nano48x32_420_4f", 60, 4), b"".join(out))


@pytest.mark.parametrize("name,qp", FIXTURE_CASES,
                         ids=[golden.key(n, q) for n, q in FIXTURE_CASES])
def test_decode_golden(name, qp):
    """The port decodes each golden intra stream (re-encoded by the port,
    hence dsv2_tpu's bytes) to dsv2_tpu's decoded y4m."""
    data = _batch_stream(name, qp)
    _check(golden.key(name, qp), data)
    _check(golden.key(name, qp), _port_y4m(data), "decode")


@pytest.mark.parametrize("key", P_SMALL)
def test_decode_p_golden(key):
    data = golden.read_stream(key)
    _check(key, data)
    _check(key, _port_y4m(data), "decode")


def test_decode_p_conformance():
    """The CIF P stream against dsv2_tpu's independent conformance
    decoder, frame by frame."""
    from dsv2_tpu.conformance import decode_stream as conf_decode
    from dsv2_tpu_torch.codec import decoder
    data = golden.read_stream(golden.p_key(golden.P_CASES[1]))
    want = list(conf_decode(io.BytesIO(data)))
    got = list(decoder.decode_stream(io.BytesIO(data), device="cpu"))
    assert [f for f, _ in got] == [f for f, _ in want] and len(got) == 12
    for (fno, frame), (_, planes) in zip(got, want):
        for c in range(3):
            assert np.array_equal(frame.view(c), planes[c]), (fno, c)


DEC_OPTS = [[], ["-y4m=1"], ["-y4m=1", "-out420p=1"], ["-postsharp=1"],
            ["-y4m=1", "-drawinfo=7"]]


@pytest.mark.parametrize("opts", DEC_OPTS,
                         ids=[" ".join(o) or "raw" for o in DEC_OPTS])
def test_decode_cli(opts, tmp_path):
    """`python -m dsv2_tpu_torch d` equals `python -m dsv2_tpu d` (both in
    process) on the 4:2:2 P stream, for every DEC_PARAMS option."""
    from dsv2_tpu import cli as jcli
    from dsv2_tpu_torch import cli
    inp = golden.stream_path(golden.p_key(golden.P_CASES[0]))
    outs = []
    for mod in (jcli, cli):
        out = str(tmp_path / ("%s.out" % mod.__name__))
        assert mod.main(["d", "-y", "-inp=" + inp, "-out=" + out]
                        + opts) == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0]) > 0
    if opts == ["-y4m=1"]:
        _check(golden.p_key(golden.P_CASES[0]), outs[1], "decode")


@pytest.mark.parametrize("key", [SMALL[0], P_SMALL[0]])
def test_decode_golden_live(key):
    """The golden decode digests are what dsv2_tpu decodes today."""
    from dsv2_tpu.codec import decoder as jdecoder
    from dsv2_tpu.utils import y4m as jy4m
    if key in P_SMALL:
        data = golden.read_stream(key)
    else:
        from dsv2_tpu import cli as jcli
        frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
        data = golden.encode(jcli, frames, meta, 60)
    _check(key, golden.decoded_y4m(jdecoder, jy4m, data), "decode")


@pytest.mark.slow
def test_decode_golden_fhd():
    """FHD: the intra stream (encoded by the port) and the P stream."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    frames, meta = read_y4m(golden.input_path(golden.FHD))
    key = golden.key(golden.FHD, 60)
    data = golden.encode(cli, frames, meta, 60, batch=encode_intra_batch,
                         chunk=8, device="cpu")
    _check(key, data)
    _check(key, _port_y4m(data), "decode")
    key = golden.p_key(golden.P_CASES[2])
    data = golden.read_stream(key)
    _check(key, data)
    _check(key, _port_y4m(data), "decode")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "dsv2_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_dsv2_tpu_imports():
    """No file of the port, nor chip_smoke.py, imports dsv2_tpu or jax."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("dsv2_tpu", "jax", "jaxlib"):
                    bad.append("%s:%d %s" % (os.path.relpath(path, REPO),
                                             node.lineno, n))
    assert len(_port_sources()) > 30
    assert {os.path.join(REPO, "dsv2_tpu_torch", *f) for f in (
        ("conformance", "d28dec.py"), ("conformance", "__init__.py"),
        ("utils", "bc2.py"))} <= set(_port_sources())
    assert not bad, bad


def test_no_cuda_raises(monkeypatch):
    """DSV2_TORCH_DEVICE defaults to cuda and never falls back silently."""
    import torch
    from dsv2_tpu_torch import default_device
    monkeypatch.setenv("DSV2_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        default_device()
    monkeypatch.setenv("DSV2_TORCH_DEVICE", "cpu")
    assert default_device().type == "cpu"


JAX_FREE = r"""
import importlib.abc, sys
class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dsv2_tpu"):
            raise ImportError(name + " is blocked in this process")
sys.meta_path.insert(0, NoJax())
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tools!r})
import torch_port_golden as golden
from dsv2_tpu_torch import cli
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.parallel.batch import encode_intra_batch
name = "nano48x32_420_4f"
assert cli.main(["e", "-y", "-v", "-y4m=1", "-qp=60", "-gop=0",
                 "-inp=" + golden.input_path(name), "-out=" + {out!r}]) == 0
frames, meta = read_y4m(golden.input_path(name))
data = golden.encode(cli, frames, meta, 60, batch=encode_intra_batch)
assert data == open({out!r}, "rb").read()
assert cli.main(["d", "-y", "-y4m=1", "-inp=" + {pinp!r},
                 "-out=" + {yout!r}]) == 0
assert cli.main(["e", "-y", "-y4m=1", "-qp=60", "-gop=4",
                 "-inp=" + golden.input_path("tiny64x48_422_4f"),
                 "-out=" + {out!r} + ".p"]) == 0
from dsv2_tpu_torch.parallel import dynbatch
from dsv2_tpu_torch.tools import probe_gang
fr, m = read_y4m(golden.input_path(name))
def factory():
    enc = cli.make_encoder(m, cli.default_enc_opts(qp=60, gop=2))
    enc.hme_backend = "gang"
    return enc
lanes = [fr[0:2], fr[2:4]]
assert dynbatch.encode_streams_lockstep(lanes, factory, width=2) == [
    golden.encode(cli, s, m, 60, gop=2, eos=False) for s in lanes]
probe_gang.run("cpu", reps=1, nb=16)
from dsv2_tpu_torch.codec import decoder
from dsv2_tpu_torch.utils import y4m
print("HOSTENC", golden.digest(golden.encode(cli, fr, m, 60, gop=4,
                                             backend="host"))["sha256"])
print("CORRUPT", golden.decode_frames(
    decoder, y4m, golden.corrupt_streams()[0])["decode"]["sha256"])
import numpy as np
from dsv2_tpu_torch import conformance
from dsv2_tpu_torch.utils import bc2
with open({pinp!r}, "rb") as f:
    assert len(list(conformance.decode_stream(f))) == 4
bc2.srgb_to_bc2(*[np.arange(256, dtype=np.uint8)] * 3)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "dsv2_tpu")]
print("PENC", golden.digest(open({out!r} + ".p", "rb").read())["sha256"])
print("JAXFREE", golden.digest(data)["sha256"])
print("DECODE", golden.digest(open({yout!r}, "rb").read())["sha256"])
"""


def test_jax_free_subprocess(tmp_path):
    """The GPU machine has no JAX: the encode entry points (intra, P and
    lockstep, P with the backend "host"), the CLI decode, the decode
    of a corrupt stream, the gang probe, the conformance decoder and the
    BC2 library run with jax and dsv2_tpu unimportable (a subprocess,
    since this one already imported both)."""
    out = str(tmp_path / "nano.dsv")
    pkey = golden.p_key(golden.P_CASES[0])
    code = JAX_FREE.format(repo=REPO, tools=os.path.join(REPO, "tools"),
                           out=out, pinp=golden.stream_path(pkey),
                           yout=str(tmp_path / "p.y4m"))
    env = dict(os.environ, DSV2_TORCH_DEVICE="cpu")
    env.pop("DSV2_XPROF", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "encoded" in res.stderr          # the -v statistics dump
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JAXFREE")]
    assert line == ["JAXFREE " + GOLD[golden.key(
        "nano48x32_420_4f", 60)]["sha256"]]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("DECODE")]
    assert line == ["DECODE " + GOLD[pkey]["decode"]["sha256"]]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("PENC")]
    assert line == ["PENC " + GOLD[pkey]["sha256"]]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("HOSTENC")]
    assert line == ["HOSTENC " + GOLD[golden.key(
        "nano48x32_420_4f", 60, 4)]["sha256"]]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("CORRUPT")]
    assert line == ["CORRUPT " + GOLD[golden.corrupt_key(0)]["decode"][
        "sha256"]]
