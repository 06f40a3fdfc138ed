"""torch port: the gang motion search's batched plain version
(dsv2_tpu_torch/ops/hme_gang.make_motion_est on CPU tensors: the plain
search lane by lane) against the port's per-lane plain search and
dsv2_tpu's XLA wave (dsv2_tpu/ops/hme_wave.make_motion_est on the CPU),
on 3 seeded lanes (tools/torch_port_golden.hme_lanes: each lane another
frame, shift, noise and quant), without and with temporal candidates.
Tolerance: none, every output is an integer. The two cases share the
WaveCfgs of tests/test_torch_hme.py, so their XLA compiles are shared.
"""
import numpy as np
import pytest
import torch

from torch_parity import REPO, assert_same, to_np
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.ops import hme_gang, hme_wave


def _jax_inputs(inputs):
    import jax.numpy as jnp

    def conv(x):
        if isinstance(x, tuple):
            return tuple(conv(a) for a in x)
        if isinstance(x, int):
            return np.int32(x)
        return jnp.asarray(to_np(x))
    return conv(inputs)


@pytest.mark.parametrize("has_tmv,effort", [(False, 10), (True, 5)])
def test_gang_plain_lanes_vs_per_lane_and_xla(has_tmv, effort):
    from dsv2_tpu.ops import hme_wave as jhw
    frames, meta = read_y4m("%s/tests/fixtures/nano48x32_420_4f.y4m" % REPO)
    cfg, lanes = golden.hme_lanes(frames, meta, 3, has_tmv=has_tmv,
                                  effort=effort)
    wcfg = hme_wave.WaveCfg(**cfg)
    got = hme_gang.make_motion_est(wcfg)(lanes)
    xla = jhw.make_motion_est(jhw.WaveCfg(**cfg))
    assert len({int(ln[9]) for ln in lanes}) == 3     # a quant per lane
    for i, inputs in enumerate(lanes):
        per_lane = hme_wave.make_motion_est(wcfg)(*inputs)
        want = xla(*_jax_inputs(inputs))
        for k in golden.HME_OUTPUTS:
            assert got[k].shape[0] == 3, k
            assert_same(got[k][i], per_lane[k], "%s lane %d" % (k, i))
            assert_same(got[k][i], np.asarray(want[k]), "%s lane %d" % (k, i))


def test_global_motion_lanes():
    """The per-lane global motion of the kernels' path equals
    hme_wave.global_motion_graph lane by lane (negative sums included:
    the division truncates)."""
    frames, meta = read_y4m("%s/tests/fixtures/odd100x62_420_4f.y4m" % REPO)
    cfg, _ = golden.hme_case(frames, meta)
    wcfg = hme_wave.WaveCfg(**cfg)
    rng = np.random.RandomState(3)
    fields = torch.as_tensor(rng.randint(-99, 60, (4, 2, wcfg.nbv, wcfg.nbh))
                             .astype(np.int32))
    for level in range(1, wcfg.pyramid_levels + 1):
        got = hme_gang.global_motion_lanes(wcfg, level, fields)
        assert got.dtype == torch.int32 and got.shape == (4, 2)
        for i in range(4):
            want = torch.stack(hme_wave.global_motion_graph(
                wcfg, level, fields[i, 0], fields[i, 1]))
            assert torch.equal(got[i], want), (level, i)


def test_gang_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """Lanes off the CPU go to the kernel path (and raise here, where
    there is no card), never to the plain version."""
    frames, meta = read_y4m("%s/tests/fixtures/nano48x32_420_4f.y4m" % REPO)
    cfg, lanes = golden.hme_lanes(frames, meta, 2)
    called = []
    monkeypatch.setattr(hme_wave, "refine_level_graph",
                        lambda *a: called.append(1))
    fn = hme_gang.make_motion_est(hme_wave.WaveCfg(**cfg))
    meta_lanes = [tuple(tuple(p.to("meta") for p in x) if isinstance(x, tuple)
                        else x.to("meta") if isinstance(x, torch.Tensor)
                        else x for x in ln) for ln in lanes]
    with pytest.raises(ValueError, match="no motion search"):
        fn(meta_lanes)
    assert not called
