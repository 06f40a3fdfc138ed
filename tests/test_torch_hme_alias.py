"""torch port: dsv2_tpu's motion search backends "host" and "wave" are
aliases of "pallas" (codec/hme), and give dsv2_tpu's streams.

- the CIF fixture at -qp=60 -gop=6, 8 frames, encoded by the port with
  hme_backend "host" and "wave" (kernels 4/5 on the card, their plain
  version on the CPU): both `dsv2_tpu`'s "host" stream
  (tools/torch_port_golden.py HOST_HME);
- 2 lockstep lanes on the nano fixture under "host": the steps go to the
  batcher under the keys of the device chain, and each lane equals its
  sequential encode; the sequential encode of the nano fixture equals
  `dsv2_tpu`'s.
Bit-exact."""
import pytest

from torch_parity import tt  # noqa: F401  (sets DSV2_TORCH_DEVICE=cpu)
import torch_port_golden as golden  # after torch_parity (sys.path)

GOLD = golden.load()


@pytest.mark.parametrize("backend", ["host", "wave"])
def test_alias_encode(backend):
    from dsv2_tpu_torch import cli
    name, qp, gop, nfr, _ = golden.HOST_HME
    want = GOLD[golden.key(name, qp, gop)]
    frames, meta = cli.read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames[:nfr], meta, qp, gop=gop, device="cpu",
                         backend=backend)
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}


def test_lockstep_alias(monkeypatch):
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel import dynbatch
    name, qp, gop = "nano48x32_420_4f", 60, 4
    frames, meta = cli.read_y4m(golden.input_path(name))
    full = golden.encode(cli, frames, meta, qp, gop=gop, device="cpu",
                         backend="host")
    want = GOLD[golden.key(name, qp, gop)]
    assert golden.digest(full) == {k: want[k] for k in ("sha256", "length")}
    lanes = [frames, frames[::-1]]
    seq = [golden.encode(cli, fr, meta, qp, gop=gop, device="cpu",
                         backend="host", eos=False) for fr in lanes]

    def factory():
        enc = cli.make_encoder(meta, cli.default_enc_opts(qp=qp, gop=gop),
                               device="cpu")
        enc.hme_backend = "host"
        return enc

    keys = []
    submit = dynbatch.LockstepBatcher.submit

    def recording(self, key, *a, **kw):
        keys.append(key[0])
        return submit(self, key, *a, **kw)

    monkeypatch.setattr(dynbatch.LockstepBatcher, "submit", recording)
    out = dynbatch.encode_streams_lockstep(lanes, factory, width=2)
    assert out == seq
    assert sorted(set(keys)) == ["hme_pl", "i_chain", "input_prep",
                                 "p_chain"], keys
