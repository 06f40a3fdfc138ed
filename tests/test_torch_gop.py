"""torch port: GOP-parallel encode and lockstep decode
(dsv2_tpu_torch/parallel/gop.py) against dsv2_tpu's parallel/gop.py.

`split_gops` runs against the twin live (pure host). `split_gop_packets`
and `decode_gops_parallel` are held to the twin's goldens (the "gops"
entry of tests/golden/torch_port_streams.json: packets per GOP and the
digest of every frame the twin's decode_gops_parallel gives) for two
multi-GOP streams, the tiny 4:2:0 clip at -qp=60 -gop=2 (3 GOPs) and
the CIF CRF stream at -gop=6 (2 GOPs, dense scans), at widths 1, 2 and
the GOP count (narrower widths split a flush into runs). The
parallel encode of the tiny clip with 1 and 3 workers must equal the
port's sequential encode of each GOP and the twin's encode_gops_parallel
(its golden digest). A lane's
error, in its host parse or in a flush, reaches the caller with no
thread left hanging. Everything on the CPU (plain kernels).
"""
import hashlib
import io
import threading

import pytest

from torch_parity import REPO  # noqa: F401  (sys.path for the golden tool)
import torch_port_golden as golden
from dsv2_tpu_torch import cli
from dsv2_tpu_torch.codec import decoder, devsteps
from dsv2_tpu_torch.parallel import gop

GOLD = golden.load()["gops"]
STREAMS = dict(golden.gops_streams())
KEYS = sorted(STREAMS)


def _run(fn, timeout=300):
    """fn() in a thread that must end within `timeout` s; returns its
    result or raises its error."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as exc:
            box["err"] = exc
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "lockstep decode hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("total,size", [(0, 4), (6, 2), (7, 3), (12, 0),
                                        (5, 8), (9, -1), (48, 48)])
def test_split_gops(total, size):
    from dsv2_tpu.parallel import gop as jgop
    assert gop.split_gops(total, size) == jgop.split_gops(total, size)


@pytest.mark.parametrize("key", KEYS)
def test_split_gop_packets(key):
    data = STREAMS[key]
    assert golden.digest(data) == {k: GOLD[key][k]
                                   for k in ("sha256", "length")}
    chunks = gop.split_gop_packets(io.BytesIO(data))
    assert [len(c) for c in chunks] == GOLD[key]["packets_per_gop"]
    # an input with no packets has no GOP
    assert gop.split_gop_packets(io.BytesIO(b"")) == []


# (stream, width): 1, 2 and every GOP in one flush, where that is more
WIDTHS = [(k, w) for k in KEYS
          for w in sorted({1, 2, len(GOLD[k]["packets_per_gop"])})]


@pytest.mark.parametrize("key,width", WIDTHS,
                         ids=["%s-w%d" % kw for kw in WIDTHS])
def test_decode_gops_parallel(key, width):
    frames = _run(lambda: gop.decode_gops_parallel(
        io.BytesIO(STREAMS[key]), width=width, device="cpu"))
    got = [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]
    assert got == GOLD[key]["frames"]


def test_encode_gops_parallel():
    name, qp, size = golden.GOPS[0]
    frames, meta = cli.read_y4m(golden.input_path(name))

    def factory():
        return cli.make_encoder(meta, cli.default_enc_opts(qp=qp, gop=size),
                                device="cpu")
    one = gop.encode_gops_parallel(frames, meta, size, factory, workers=1)
    three = _run(lambda: gop.encode_gops_parallel(frames, meta, size,
                                                  factory, workers=3))
    # the sequential encode of each GOP by an encoder of its own
    seq = b"".join(golden.encode(cli, frames[s:e], meta, qp, gop=size,
                                 eos=False, device="cpu")
                   for s, e in gop.split_gops(len(frames), size))
    seq += b"".join(factory().end_of_stream())
    assert one == three == seq
    assert golden.digest(one) == GOLD[golden.key(name, qp, size)][
        "encode_gops_parallel"]


def test_decode_lane_error_reaches_caller(monkeypatch):
    """A lane failing in its host parse, and a flush failing, both reach
    the caller; the other lanes finish or fail, none hangs."""
    data = STREAMS[golden.key(*golden.GOPS[0])]
    parse = decoder.Decoder.parse_packet
    seen = []

    def failing_parse(self, buf):
        seen.append(buf)
        if len(seen) == 5:
            raise ValueError("parse failed")
        return parse(self, buf)
    monkeypatch.setattr(decoder.Decoder, "parse_packet", failing_parse)
    with pytest.raises(ValueError, match="parse failed"):
        _run(lambda: gop.decode_gops_parallel(io.BytesIO(data),
                                              device="cpu"))
    monkeypatch.setattr(decoder.Decoder, "parse_packet", parse)

    def boom(cfg):
        raise RuntimeError("flush failed")
    monkeypatch.setattr(devsteps, "make_id_chain_lanes", boom)
    monkeypatch.setattr(devsteps, "make_pd_chain_lanes", boom)
    with pytest.raises(RuntimeError, match="flush failed"):
        _run(lambda: gop.decode_gops_parallel(io.BytesIO(data), width=2,
                                              device="cpu"))
