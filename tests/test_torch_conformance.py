"""torch port: its copy of the independent conformance decoder
(dsv2_tpu_torch/conformance, numpy only) on every committed golden
stream but the FHD one: the y4m it writes equals `dsv2_tpu`'s decode
digest, and, for the multi-GOP streams, each frame `dsv2_tpu`'s."""
import hashlib
import io

import pytest

from torch_parity import REPO  # noqa: F401  (sys.path for the golden tool)
import torch_port_golden as golden  # after torch_parity (sys.path)

GOLD = golden.load()
STREAMS = sorted(k for k, v in GOLD.items()
                 if isinstance(v, dict) and "stream" in v
                 and not k.startswith(golden.FHD))
GOPS = sorted(GOLD["gops"])


@pytest.mark.parametrize("key", STREAMS)
def test_conformance_decode_file(key, tmp_path):
    from dsv2_tpu_torch.conformance import decode_file
    out = tmp_path / "out.y4m"
    decode_file(golden.stream_path(key), str(out))
    data = out.read_bytes()
    want = GOLD[key]["decode"]
    assert len(data) == want["length"]
    assert hashlib.sha256(data).hexdigest() == want["sha256"]


@pytest.mark.parametrize("key", GOPS)
def test_conformance_decode_stream(key):
    from dsv2_tpu_torch.conformance import decode_stream
    got = [hashlib.sha256(b"".join(p.tobytes() for p in planes)).hexdigest()
           for _, planes in decode_stream(io.BytesIO(golden.read_stream(key)))]
    assert got == GOLD["gops"][key]["frames"]
