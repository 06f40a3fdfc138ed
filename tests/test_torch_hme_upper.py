"""torch port: the upper motion-search levels (kernels 4 and 6) on the
dataflow scheduler, run on the host.

csrc/hme_search.cu and csrc/hme_gang.cu, built by the host C++ compiler
against the CUDA shim of tests/torch_parity.py (each warp an OS thread
running its lanes as fibers), search every upper pyramid level with its
blocks claimed through csrc/hme_sched.cuh and each block split around the
wait for its neighbours; with 1, 2 and 3 workers every level equals the
plain version (ops/hme_wave.refine_level_graph) bit for bit, fed the same
parent field and global motion: kernel 4 on nano inputs with and without
temporal candidates, odd (where a neighbour's vector displaces the start
of the refine run before the wait), 4:2:2, 32x32 blocks and CIF; kernel
6 on 3 lanes in one launch at 1 and 2 blocks per warp. Only the card
shows that nvcc takes the sources and how fast they run
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import pytest
import torch

from torch_parity import assert_same, hme_host_build, in_time, ptr
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.ops import hme_gpu, hme_wave

WORKERS = (1, 2, 3)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return hme_host_build(str(tmp_path_factory.mktemp("hme_upper")))


def _plain_levels(cfg, lanes):
    """Per upper level, top down: (parent, gxy, want) of every lane, the
    plain version's fields fed the plain version's parents."""
    n = len(lanes)
    parent = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32)
    gxy = torch.zeros((n, 2), dtype=torch.int32)
    out = []
    for level in range(cfg.pyramid_levels, 0, -1):
        want = torch.stack([torch.stack(hme_wave.refine_level_graph(
            cfg, level, ln[0][level], ln[1][level], ln[2][level],
            parent[i, 0], parent[i, 1], ln[7], ln[8], gxy[i, 0], gxy[i, 1],
            int(ln[9]))) for i, ln in enumerate(lanes)])
        out.append((level, parent, gxy, want))
        parent = want
        gxy = torch.stack([torch.stack(hme_wave.global_motion_graph(
            cfg, level, w[0], w[1])) for w in want])
    return out


# (input, has_tmv, effort, hme_case keywords)
CASES = [("nano48x32_420_4f", False, 10, {}),
         ("nano48x32_420_4f", True, 5, {}),
         ("odd100x62_420_4f", True, 10, {}),
         ("tiny64x48_422_4f", True, 8, {}),
         ("tiny64x48_420_6f", True, 10, dict(blk=32)),
         ("cif352x288_420_12f", True, 10, {})]


@pytest.fixture(scope="module")
def plain_cases():
    """The inputs and plain fields of every CASES entry (computed once)."""
    out = {}
    for name, has_tmv, effort, kw in CASES:
        frames, meta = read_y4m(golden.input_path(name))
        cfgd, inputs = golden.hme_case(frames, meta, has_tmv=has_tmv,
                                       effort=effort, **kw)
        cfg = hme_wave.WaveCfg(**cfgd)
        out[name, has_tmv] = cfg, inputs, _plain_levels(cfg, [inputs])
    return out


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("name,has_tmv,effort,kw", CASES,
                         ids=["%s-tmv%d-e%d%s" % (c[0], c[1], c[2], "".join(
                             "-%s%s" % kv for kv in c[3].items()))
                             for c in CASES])
def test_upper_levels_on_host(host, plain_cases, name, has_tmv, effort, kw,
                              workers):
    """Kernel 4 (dsv2t_hme_level) at every upper level against the plain
    version, `workers` warps claiming the level's blocks."""
    cfg, inputs, levels = plain_cases[name, has_tmv]
    sp, rp, op, _, _, _, _, tmx, tmy, quant, _ = inputs
    tmv = torch.stack([tmx, tmy]).contiguous()
    assert levels
    for level, parent, gxy, want in levels:
        got = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32)
        sched = hme_gpu._sched(cfg, 1, "cpu", level)
        geom = hme_gpu.geometry(cfg, level, [sp[level]], [], int(quant), 0)
        rc = in_time(lambda: host["dsv2t_hme_level"](
            *(ptr(t) for t in (sp[level], rp[level], op[level], parent[0],
                               tmv, gxy[0], got, sched)), workers,
            geom.ctypes.data, None))
        assert rc == 0
        assert_same(got, want[0], "level %d, %d workers" % (level, workers))
        # every block's ticket was claimed and its flag published
        _, ca, cb, _ = hme_wave.lane_grid(cfg, level)
        assert torch.equal(sched[1:], torch.ones(ca * cb, dtype=torch.int32))


@pytest.fixture(scope="module")
def gang_case():
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    cfgd, lanes = golden.hme_lanes(frames, meta, 3, has_tmv=True, effort=10)
    cfg = hme_wave.WaveCfg(**cfgd)
    return cfg, lanes, _plain_levels(cfg, lanes)


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("gang", [1, 2])
def test_gang_upper_levels_on_host(host, gang_case, gang, workers):
    """Kernel 6 (dsv2t_hme_gang) at every upper level: 3 lanes in one
    launch, `gang` blocks per warp, against the plain version lane by
    lane."""
    cfg, lanes, levels = gang_case
    n = len(lanes)
    tmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]
                      ).contiguous()
    quants = [int(ln[9]) for ln in lanes]
    for level, parent, gxy, want in levels:
        planes = [([ln[k][level] for k in range(3)], []) for ln in lanes]
        out = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32)
        geom, ptrs, scal = hme_gpu._gang_args(
            cfg, level, planes, parent.contiguous(), tmv, gxy.contiguous(),
            out, None, quants, [0] * n, gang)
        sched = hme_gpu._sched(cfg, n, "cpu", level)
        rc = in_time(lambda: host["dsv2t_hme_gang"](
            0, 32 // gang, n, geom.ctypes.data, ptrs.ctypes.data,
            scal.ctypes.data, ptr(sched), workers, None))
        assert rc == 0
        assert_same(out, want, "level %d, G = %d, %d workers"
                    % (level, gang, workers))


def test_upper_level_needs_scheduler(host, plain_cases):
    """Kernel 4 refuses a launch without the scheduler's scratch."""
    cfg, inputs, levels = plain_cases["nano48x32_420_4f", False]
    sp, rp, op, _, _, _, _, tmx, tmy, quant, _ = inputs
    level, parent, gxy, _ = levels[0]
    tmv = torch.stack([tmx, tmy]).contiguous()
    got = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32)
    geom = hme_gpu.geometry(cfg, level, [sp[level]], [], int(quant), 0)
    args = [ptr(t) for t in (sp[level], rp[level], op[level], parent[0],
                             tmv, gxy[0], got)]
    assert host["dsv2t_hme_level"](*args, None, 0, geom.ctypes.data,
                                   None) != 0
    assert not got.any()
