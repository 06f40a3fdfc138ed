"""torch port: the motion search's plain version (dsv2_tpu_torch/ops/
hme_wave.py, what ops/hme_gpu runs for CPU tensors) against dsv2_tpu's
XLA wave (dsv2_tpu/ops/hme_wave.make_motion_est on the CPU), on the
same seeded inputs (tools/torch_port_golden.hme_case: shifted and noised
copies of a fixture frame). Tolerance: none, every output is an integer;
all seven fields and the four frame sums must be equal. Each case is one
XLA compile (~20-30 s here), so the cases share geometry where they can:
nano 4:2:0 without temporal candidates, nano with them at effort 5 (the
half-pel-only subpel mask, no chroma intra test), odd 100x62 with them.
"""
import numpy as np
import pytest

from torch_parity import REPO, assert_same, to_np
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.ops import hme_gpu, hme_wave

CASES = [("nano48x32_420_4f", False, 10), ("nano48x32_420_4f", True, 5),
         ("odd100x62_420_4f", True, 10)]
_fired = {}


def _jax_inputs(inputs):
    import jax.numpy as jnp

    def conv(x):
        if isinstance(x, tuple):
            return tuple(conv(a) for a in x)
        if isinstance(x, int):
            return np.int32(x)
        return jnp.asarray(to_np(x))
    return conv(inputs)


@pytest.mark.parametrize("name,has_tmv,effort", CASES)
def test_motion_search_plain_vs_xla(name, has_tmv, effort):
    from dsv2_tpu.ops import hme_wave as jhw
    frames, meta = read_y4m("%s/tests/fixtures/%s.y4m" % (REPO, name))
    cfg, inputs = golden.hme_case(frames, meta, has_tmv=has_tmv,
                                  effort=effort)
    got = hme_gpu.make_motion_est(hme_wave.WaveCfg(**cfg))(*inputs)
    want = jhw.make_motion_est(jhw.WaveCfg(**cfg))(*_jax_inputs(inputs))
    for k in golden.HME_OUTPUTS:
        assert_same(got[k], np.asarray(want[k]), k)
    fl = to_np(got["flags"])
    sub = (to_np(got["fx"]) | to_np(got["fy"])) & 3
    for bit, what in ((K.MV_BIT_INTRA, "intra"), (K.MV_BIT_SKIP, "skip"),
                      (K.MV_BIT_EPRM, "eprm")):
        _fired[what] = _fired.get(what, 0) + int(((fl >> bit) & 1).sum())
    _fired["subpel"] = _fired.get("subpel", 0) + int((sub != 0).sum())


def test_branches_fired():
    """The cases above reach every decision branch at least once (this
    runs after them in the same file)."""
    if len(_fired) < 4:
        pytest.skip("needs the parity cases of this file to have run")
    assert all(v > 0 for v in _fired.values()), _fired


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel launch (and raises here,
    where there is no card), never to the plain version."""
    import torch
    frames, meta = read_y4m("%s/tests/fixtures/nano48x32_420_4f.y4m" % REPO)
    cfg, inputs = golden.hme_case(frames, meta)
    called = []
    monkeypatch.setattr(hme_wave, "refine_level_graph",
                        lambda *a: called.append(1))
    fn = hme_gpu.make_motion_est(hme_wave.WaveCfg(**cfg))
    meta_in = tuple(tuple(p.to("meta") for p in x) if isinstance(x, tuple)
                    else x.to("meta") if isinstance(x, torch.Tensor) else x
                    for x in inputs)
    with pytest.raises(ValueError, match="no motion search"):
        fn(*meta_in)
    assert not called


def test_hme_backend_choice_raises():
    """The backend mapping: "host", "wave" and "auto" are "pallas"; only
    an unknown name raises (the name is from when "host" and "wave"
    raised)."""
    from types import SimpleNamespace
    from dsv2_tpu_torch.codec import hme
    for name, want in (("host", "pallas"), ("wave", "pallas"),
                       ("auto", "pallas"), ("pallas", "pallas"),
                       ("gang", "gang")):
        enc = SimpleNamespace(hme_backend=name)
        assert hme.resolve_backend(enc) == want, name
    with pytest.raises(ValueError, match="unknown hme_backend"):
        hme.resolve_backend(SimpleNamespace(hme_backend="xla"))
