"""torch port: decoding corrupt streams on the device chain to the bytes
`dsv2_tpu` decodes on its host chain (ref: dsv_decoder.c; the twin's
`Decoder._execute_job`).

- the 8 seeded byte-flip trials of the committed CIF CRF stream
  (tools/torch_port_golden.py CORRUPT: tests/test_robustness.py's scheme)
  decoded by the port on the CPU: every frame's digest, the y4m, the
  error (none) and the corrupt P and intra planes equal `dsv2_tpu`'s;
- among them at least one corrupt P plane and one corrupt intra plane;
- live, the tiny 4:2:0 stream of tests/test_robustness.py with the same
  trials decoded by both packages, frame for frame;
- the port's CLI `d` of one corrupt stream, `dsv2_tpu`'s y4m bytes.
Bit-exact."""
import hashlib

import pytest

from torch_parity import tt  # noqa: F401  (sets DSV2_TORCH_DEVICE=cpu)
import torch_port_golden as golden  # after torch_parity (sys.path)

GOLD = golden.load()
TRIALS = golden.corrupt_streams()


def _port_decode(data):
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    dec = decoder.Decoder(device="cpu")
    bad = golden.count_bad_planes(dec)
    out = golden.decode_frames(decoder, y4m, data, decoder=dec)
    return out, bad, dec


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_corrupt_trial(trial):
    want = GOLD[golden.corrupt_key(trial)]
    data = TRIALS[trial]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    got, bad, dec = _port_decode(data)
    assert got["error"] == want["error"]
    assert got["frames"] == want["frames"]
    assert got["decode"] == want["decode"]
    assert bad == want["bad_planes"]
    assert dec.ref_dev is not None   # the reference stayed on the device


def test_corrupt_planes_hit():
    """The trials reach both recoveries: a corrupt P plane (zero
    residual) and a corrupt intra plane (zeroed)."""
    tot = {"p": 0, "intra": 0}
    for i in range(len(TRIALS)):
        for k, n in GOLD[golden.corrupt_key(i)]["bad_planes"].items():
            tot[k] += n
    assert tot["p"] >= 1 and tot["intra"] >= 1, tot


def test_corrupt_live_tiny():
    """tests/test_robustness.py's stream (tiny 4:2:0, -qp=60 -gop=3),
    encoded by the port, with the seeded trials: the port decodes every
    trial as dsv2_tpu does, frame for frame."""
    from dsv2_tpu.codec import decoder as jdec
    from dsv2_tpu.utils import y4m as jy4m
    from dsv2_tpu_torch import cli
    frames, meta = cli.read_y4m(golden.input_path("tiny64x48_420_6f"))
    data = golden.encode(cli, frames, meta, 60, gop=3, device="cpu")
    nbad = 0
    for buf in golden.corrupt_streams(data):
        jd = jdec.Decoder()
        jbad = golden.count_bad_planes(jd)
        want = golden.decode_frames(jdec, jy4m, buf, decoder=jd)
        got, bad, _ = _port_decode(buf)
        assert got == want
        assert bad == jbad
        nbad += sum(bad.values())
    assert nbad > 0


def test_cli_decode_corrupt(tmp_path):
    """`python -m dsv2_tpu_torch d -y4m=1` of a corrupt stream writes the
    y4m `dsv2_tpu` decodes from it."""
    from dsv2_tpu_torch.cli import main
    trial = next(i for i in range(len(TRIALS))
                 if GOLD[golden.corrupt_key(i)]["bad_planes"]["p"])
    inp, out = tmp_path / "c.dsv", tmp_path / "c.y4m"
    inp.write_bytes(TRIALS[trial])
    assert main(["d", "-y", "-y4m=1", "-inp=%s" % inp,
                 "-out=%s" % out]) == 0
    want = GOLD[golden.corrupt_key(trial)]["decode"]
    got = out.read_bytes()
    assert len(got) == want["length"]
    assert hashlib.sha256(got).hexdigest() == want["sha256"]
