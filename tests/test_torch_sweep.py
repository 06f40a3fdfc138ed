"""torch port: the encoder's flag surface on the CPU. Every case of
tests/test_sweep.py's SWEEP on the tiny fixtures (ABR, per-GOP rate
control, 4:4:4/4:1:1/4:1:0 P encode, -tempaq=0, -stabref=2, forced
block sizes, efforts 0/3/10, lossless P), each encoder flag SWEEP leaves
out at a non-default value (tools/torch_port_golden.SWEEP), raw UYVY
input, and lockstep lanes through the gang motion search at effort 3,
lossless, -bszx=1 -bszy=0 and ABR (GANG), all through the port's CLI
(`cli.main`, in process) or its lockstep entry point: each stream, and
the port's decode of it, equals `dsv2_tpu`'s golden digest. The qcif
cases are in tests/test_torch_sweep_qcif.py."""
import hashlib

import pytest

from torch_parity import REPO  # noqa: F401  (sys.path, DSV2_TORCH_DEVICE)
import torch_port_golden as golden  # after torch_parity (sys.path)

GOLD = golden.load()
CASES = [c for c in golden.sweep_cases() if "qcif" not in c[1]]


def _check(want, data):
    assert len(data) == want["length"]
    assert hashlib.sha256(data).hexdigest() == want["sha256"]


def _port_y4m(data):
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    return golden.decoded_y4m(decoder, y4m, data,
                              decoder=decoder.Decoder(device="cpu"))


def sweep_case(k, name, args, tmp_path):
    """The port's CLI stream of a sweep case and its decode, against the
    golden digests."""
    from dsv2_tpu_torch import cli
    data = golden.cli_encode(cli, name, args, str(tmp_path / "out.dsv"))
    _check(GOLD[k], data)
    _check(GOLD[k]["decode"], _port_y4m(data))


@pytest.mark.parametrize("k,name,args", CASES, ids=[c[0] for c in CASES])
def test_sweep(k, name, args, tmp_path):
    sweep_case(k, name, args, tmp_path)


@pytest.mark.parametrize("name,nlanes,args", golden.GANG,
                         ids=[" ".join(g[2]) for g in golden.GANG])
def test_gang(name, nlanes, args):
    """encode_streams_lockstep with the gang backend: every lane equals
    `dsv2_tpu`'s sequential encode of its frames (no EOS)."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import hme
    from dsv2_tpu_torch.parallel import dynbatch
    from dsv2_tpu_torch.utils.packet import encode_eos
    lanes, meta = golden.gang_lanes(name, nlanes)

    def factory():
        enc = cli.make_encoder(meta, golden.cli_opts(cli, args),
                               device="cpu")
        enc.hme_backend = "gang"
        assert hme.resolve_backend(enc) == "gang"
        return enc
    outs = dynbatch.encode_streams_lockstep(lanes, factory, width=nlanes)
    for i, data in enumerate(outs):
        want = GOLD[golden.gang_key(name, args, i)]
        _check(want, data)
        _check(want["decode"], _port_y4m(data + encode_eos()))
