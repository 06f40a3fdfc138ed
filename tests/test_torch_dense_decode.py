"""torch port: decode of pictures whose scans the compact upload cannot
carry. `devsteps.compact_vs` gives None when a plane has more than 64
high-band values outside int8 (high quality streams: the CLI's default
CRF, -qp >= 85); the decoder then uploads that picture's dense int32
scans and stays on the device chain (`devsteps.scan_upload`). Streams
from tools/torch_port_golden.py's DENSE_CASES, decoded through the port
on the CPU, must give `dsv2_tpu`'s decoded y4m digests."""
import hashlib
import io

import numpy as np
import pytest
import torch

from torch_parity import assert_same
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.codec import devsteps
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.ops import hzcc

GOLD = golden.load()
CIF_DENSE = [c for c in golden.DENSE_CASES if c[0] != golden.FHD]
KEYS = [golden.key(n, q, g) for n, q, g, _ in CIF_DENSE]


def _check(key, data, what=None):
    want = GOLD[key] if what is None else GOLD[key][what]
    assert len(data) == want["length"], key
    assert hashlib.sha256(data).hexdigest() == want["sha256"], key


@pytest.fixture
def compact_calls(monkeypatch):
    """Every compact_vs result of the decodes in the test."""
    calls = []
    real = devsteps.compact_vs

    def rec(*a):
        out = real(*a)
        calls.append(out)
        return out
    monkeypatch.setattr(devsteps, "compact_vs", rec)
    return calls


@pytest.mark.parametrize("key", KEYS)
def test_dense_decode_golden(key, compact_calls):
    """The committed stream (dsv2_tpu's bytes) decodes through
    decode_stream_chunked to dsv2_tpu's y4m, and at least one of its
    pictures took the dense upload."""
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    data = golden.read_stream(key)
    _check(key, data)
    got = golden.decoded_y4m(decoder, y4m, data,
                             decoder=decoder.Decoder(device="cpu"))
    _check(key, got, "decode")
    assert any(c is None for c in compact_calls), key
    assert len(compact_calls) == GOLD[key]["frames"]


def test_dense_decode_cli(tmp_path, compact_calls):
    """`python -m dsv2_tpu_torch d -y4m=1` (in process) on the CRF
    stream writes dsv2_tpu's y4m."""
    from dsv2_tpu_torch.cli import main
    out = tmp_path / "out.y4m"
    assert main(["d", "-y", "-y4m=1", "-inp=" + golden.stream_path(KEYS[0]),
                 "-out=%s" % out]) == 0
    _check(KEYS[0], out.read_bytes(), "decode")
    assert any(c is None for c in compact_calls)


def test_dense_decode_single_frames(compact_calls):
    """decode_stream (one picture per call, no chunks) gives the frames
    of decode_stream_chunked on the -qp=85 stream."""
    from dsv2_tpu_torch.codec import decoder
    data = golden.read_stream(KEYS[1])
    one = list(decoder.decode_stream(io.BytesIO(data), device="cpu"))
    chunked = list(decoder.decode_stream_chunked(
        io.BytesIO(data), decoder=decoder.Decoder(device="cpu")))
    assert [f for f, _ in one] == [f for f, _, _ in chunked] == [0, 1, 2]
    for (_, a), (_, _, b) in zip(one, chunked):
        for c in range(3):
            assert np.array_equal(a.view(c), b.view(c))
    assert all(c is None for c in compact_calls)


def test_dense_encode_golden():
    """The port's own encode of the -qp=85 case is dsv2_tpu's stream (so
    the port decodes what it encodes)."""
    from dsv2_tpu_torch import cli
    name, qp, gop, nfr = CIF_DENSE[1]
    frames, meta = read_y4m(golden.input_path(name))
    _check(KEYS[1], golden.encode(cli, frames[:nfr], meta, qp, gop=gop,
                                  device="cpu"))


@pytest.mark.parametrize("lossless", [False, True])
def test_scan_upload(lossless):
    """scan_upload: compact_vs's form with 64 out-of-int8 values in a
    plane, dense int32 vectors with 65 or when lossless; _expand_vs
    passes dense vectors through and expands the compact form."""
    pc = devsteps._pcfg(100, 62, K.SUBSAMP_420, 16, 16, True, lossless)
    rng = np.random.default_rng(3)
    for nover in (64, 65):
        vs = []
        for c in range(3):
            total = hzcc.total_scan_coefs(*pc.cdims[c])
            v = rng.integers(-127, 128, total).astype(np.int32)
            n = devsteps._ll_ns(pc)[c]
            pos = rng.choice(np.arange(n, total), nover, replace=False)
            v[pos] = rng.choice([-1, 1], nover) * rng.integers(128, 900,
                                                                 nover)
            vs.append(v)
        up, dense = devsteps.scan_upload(pc, vs, lossless)
        assert dense == (lossless or nover > devsteps._NFIX)
        if dense:
            assert all(u.dtype == np.int32 for u in up)
            dev = tuple(torch.from_numpy(u) for u in up)
        else:
            dev = tuple(tuple(torch.from_numpy(a) for a in p) for p in up)
        assert_same(devsteps._expand_vs(dev, dense), vs, "upload round trip")

