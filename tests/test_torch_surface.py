"""torch port: its public surface beside `dsv2_tpu`'s, on the CPU, held to
the committed `dsv2_tpu` goldens (tests/golden/torch_port_streams.json,
tools/torch_port_golden.py): encode_intra_batch at gop != 0 (every frame
intra, a metadata packet at each GOP start), Decoder.decode_packet, the
SUBSAMP_* re-exports, the BC2 colour library against `dsv2_tpu`'s, the
DSV2_XPROF profiler capture, the -l2 device-buffer report and the
dsv2mp4.sh interop script."""
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
CRF_STREAM = golden.CORRUPT["stream"]


def _check(want, data):
    assert len(data) == want["length"]
    assert hashlib.sha256(data).hexdigest() == want["sha256"]


@pytest.mark.parametrize("case", golden.BATCH_GOP,
                         ids=[golden.batch_key(c) for c in golden.BATCH_GOP])
def test_batch_any_gop(case):
    """encode_intra_batch at -gop=2 (tiny, chunks of 3: metadata packets
    in mid-chunk) and at the CLI's default CRF with -gop=6 (CIF, chunks
    of 4: dense-fallback planes, a GOP across a chunk boundary) gives
    `dsv2_tpu`'s encode_intra_batch stream, which the port's decoder
    turns into `dsv2_tpu`'s y4m."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    from dsv2_tpu_torch.utils import y4m
    name, qp, gop, chunk = case
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames, meta, qp, batch=encode_intra_batch,
                         chunk=chunk, gop=gop, device="cpu")
    want = GOLD[golden.batch_key(case)]
    _check(want, data)
    _check(want["decode"], golden.decoded_y4m(
        decoder, y4m, data, decoder=decoder.Decoder(device="cpu")))


def _decode_packets(data):
    """[fno, SHA-256 of the visible planes] of every picture
    Decoder.decode_packet returns for `data`, packet by packet."""
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import packet
    dec = decoder.Decoder(device="cpu")
    out = []
    for _, buf in packet.iter_packets(io.BytesIO(data)):
        code, frame, fno = dec.decode_packet(buf)
        if code == decoder.DEC_EOS:
            break
        if code == decoder.DEC_OK and frame is not None:
            out.append([fno, hashlib.sha256(frame.tobytes()).hexdigest()])
    return out


def test_decode_packet():
    """Decoder.decode_packet (the non-lazy call) on the CIF CRF stream:
    every frame equals `dsv2_tpu`'s decode of it."""
    got = _decode_packets(golden.read_stream(CRF_STREAM))
    want = GOLD["gops"][CRF_STREAM]["frames"]
    assert [d for _, d in got] == want
    assert [f for f, _ in got] == list(range(len(want)))


def test_decode_packet_corrupt():
    """Decoder.decode_packet on corrupt trial 0 of that stream: the frames
    `dsv2_tpu` decodes from it."""
    want = GOLD[golden.corrupt_key(0)]
    assert sum(want["bad_planes"].values()) > 0
    assert _decode_packets(golden.corrupt_streams()[0]) == want["frames"]


def test_subsamp_exports():
    """The package root re-exports the chroma formats, as dsv2_tpu's does."""
    import dsv2_tpu
    import dsv2_tpu_torch
    from dsv2_tpu_torch.core import constants as K
    names = ["SUBSAMP_444", "SUBSAMP_422", "SUBSAMP_UYVY", "SUBSAMP_420",
             "SUBSAMP_411", "SUBSAMP_410"]
    for n in names:
        assert getattr(dsv2_tpu_torch, n) == getattr(K, n) == getattr(
            dsv2_tpu, n), n


@pytest.mark.parametrize("full_range", [True, False])
def test_bc2_parity(full_range):
    """utils/bc2 equals dsv2_tpu.utils.bc2 in both directions on seeded
    random RGB and BC2 triples (every 8-bit value of each channel among
    them)."""
    from dsv2_tpu.utils import bc2 as jbc2
    from dsv2_tpu_torch.utils import bc2
    rng = np.random.default_rng(11 + full_range)
    for a in (rng.integers(0, 256, (3, 1 << 16), dtype=np.uint8),
              np.stack([np.arange(256, dtype=np.uint8)] * 3)):
        for fwd in ("srgb_to_bc2", "bc2_to_srgb"):
            got = getattr(bc2, fwd)(*a, full_range=full_range)
            want = getattr(jbc2, fwd)(*a, full_range=full_range)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), fwd


def test_mem_report_cpu():
    """log.mem_report() is (0, 0) in a process that has not used a card."""
    from dsv2_tpu_torch.utils import log
    assert log.mem_report() == (0, 0)


def _run(args, env=None, **kw):
    e = dict(os.environ, DSV2_TORCH_DEVICE="cpu")
    e.pop("DSV2_XPROF", None)
    e.update(env or {})
    return subprocess.run(args, cwd=REPO, env=e, capture_output=True,
                          timeout=300, **kw)


def test_l2_report_stdout(tmp_path):
    """`e -v -l2` to stdout: the stream on stdout is the golden one, byte
    for byte; the device-buffer report goes to the log stream."""
    name = "nano48x32_420_4f"
    res = _run([sys.executable, "-m", "dsv2_tpu_torch", "e", "-y", "-v",
                "-l2", "-y4m=1", "-qp=60", "-gop=0",
                "-inp=" + golden.input_path(name), "-out=-"])
    assert res.returncode == 0, res.stderr[-3000:]
    _check(GOLD[golden.key(name, 60)], res.stdout)
    assert b"[DSV INFO] device buffers live: 0 (0.0 MiB)" in res.stderr


def test_xprof_trace(tmp_path):
    """DSV2_XPROF=<dir> writes a torch.profiler Chrome trace of the run
    into <dir> at exit (CPU activity here), and the stream is unchanged;
    without it nothing is written."""
    import json
    name = "nano48x32_420_4f"
    out = tmp_path / "out.dsv"
    d = tmp_path / "xprof"
    res = _run([sys.executable, "-m", "dsv2_tpu_torch", "e", "-y", "-y4m=1",
                "-qp=60", "-gop=0", "-inp=" + golden.input_path(name),
                "-out=%s" % out], env={"DSV2_XPROF": str(d)})
    assert res.returncode == 0, res.stderr[-3000:]
    _check(GOLD[golden.key(name, 60)], out.read_bytes())
    traces = list(d.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    res = _run([sys.executable, "-c", "import dsv2_tpu_torch.utils.trace "
                "as t; assert t._xprof is None"])
    assert res.returncode == 0, res.stderr[-3000:]


def test_dsv2mp4(tmp_path):
    """dsv2_tpu_torch/tools/dsv2mp4.sh pipes the port's `d -y4m=1` into
    ffmpeg: with a stub ffmpeg that copies its input to its last
    argument, the file is `dsv2_tpu`'s decoded y4m."""
    stub = tmp_path / "bin" / "ffmpeg"
    stub.parent.mkdir()
    stub.write_text('#!/bin/sh\nfor a; do last="$a"; done\n'
                    'cat > "$last"\n')
    stub.chmod(0o755)
    key = golden.p_key(golden.P_CASES[0])
    out = tmp_path / "out.mp4"
    res = _run(["sh", os.path.join(REPO, "dsv2_tpu_torch", "tools",
                                   "dsv2mp4.sh"),
                golden.stream_path(key), str(out)],
               env={"PATH": "%s:%s" % (stub.parent, os.environ["PATH"]),
                    "PYTHON": sys.executable}, text=False)
    assert res.returncode == 0, res.stderr[-3000:]
    _check(GOLD[key]["decode"], out.read_bytes())
