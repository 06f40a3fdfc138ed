"""The motion search's byte counts (rooflines/hme_level.py, kernel 4;
rooflines/hme_level0.py, kernel 5) against counts by hand at 64x48 in
16x16 blocks (derived in each file's docstring), from the parameter
block the port's own wrappers pass, and their kernel patterns against
the profiler's names."""
import os

import torch

from codecbench.harness import load_module
from conftest import REPO

from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.ops import hme_gpu
from dsv2_tpu_torch.ops import hme_wave as hw


def roofline(name):
    return load_module(os.path.join(REPO, "codecbench", "rooflines",
                                    name + ".py"), "rl_" + name)


def wave_cfg(has_tmv=True, levels=3):
    """The search's configuration of a 64x48 4:2:0 frame in 16x16
    blocks (nbh 4, nbv 3)."""
    dims = ((64, 48),) + tuple((-(-64 >> i), -(-48 >> i))
                               for i in range(1, levels + 1))
    return hw.WaveCfg(4, 3, 16, 16, 64, 48, K.SUBSAMP_420, K.MAX_EFFORT,
                      False, levels, has_tmv, False, dims)


def geom(cfg, level):
    """The parameter block the wrapper of `level` passes its kernel."""
    fw, fh = cfg.dims[level]
    plane = torch.zeros((fh + 2 * hw.B, fw + 2 * hw.B), dtype=torch.uint8)
    chroma = [torch.zeros((24 + 2 * hw.B, 32 + 2 * hw.B),
                          dtype=torch.uint8)] * 4 if level == 0 else []
    return hme_gpu.geometry(cfg, level, [plane], chroma, 60, 0)


def test_hme_level_bytes_by_hand():
    rl = roofline("hme_level")
    g = rl.record(*[None] * 8, geom(wave_cfg(), 1))
    assert (g["level"], g["fw"], g["fh"]) == (1, 32, 24)
    # level 1 of 3: three 32 x 24 planes; the 2 x 2 blocks' tmv and out
    # (2 int32 fields each), the 1 x 1 parent, the global motion
    assert rl.nbytes(g) == 3 * 32 * 24 + 8 * 4 + 8 * 4 + 8 * 1 + 8 == 2384


def test_hme_level_top_level_without_tmv():
    rl = roofline("hme_level")
    g = rl.record(*[None] * 8, geom(wave_cfg(has_tmv=False), 3))
    # level 3 of 3 (8 x 6 planes, one block): no parent, no tmv
    assert rl.nbytes(g) == 3 * 8 * 6 + 8 + 8 * 1 == 160


def test_hme_level0_bytes_by_hand():
    rl = roofline("hme_level0")
    g = rl.record(*[None] * 10, geom(wave_cfg(), 0))
    assert (g["fw"], g["fh"], g["hs"], g["vs"]) == (64, 48, 1, 1)
    # three 64 x 48 luma planes, four 32 x 24 chroma planes; the 2 x 2
    # parent, the 12 blocks' tmv, the global motion; 7 int32 fields of
    # 12 blocks and 4 sums written
    assert rl.nbytes(g) == (3 * 64 * 48 + 4 * 32 * 24 + 8 * 4 + 8 * 12 + 8
                            + 28 * 12 + 16) == 12776
    g = rl.record(*[None] * 10, geom(wave_cfg(has_tmv=False), 0))
    assert rl.nbytes(g) == 12776 - 8 * 12


def test_records_take_the_wrappers_arguments():
    """record() takes what hme_gpu passes the launch wrappers (9 and 11
    arguments, the parameter block last) and keeps no tensor."""
    cfg = wave_cfg()
    for name, nargs, level in (("hme_level", 9, 2), ("hme_level0", 11, 0)):
        args = [torch.zeros(1)] * (nargs - 1) + [geom(cfg, level)]
        g = roofline(name).record(*args)
        assert all(isinstance(v, int) for v in g.values())
        assert g["level"] == level
        assert list(g) == list(hme_gpu.GEOM)


def test_kernel_patterns_match_profiler_names():
    lvl = roofline("hme_level").KERNEL
    lvl0 = roofline("hme_level0").KERNEL
    assert lvl.search("(anonymous namespace)::hme_level_kernel(G, Lv, Dag)")
    assert lvl0.search(
        "(anonymous namespace)::hme_level0_kernel(G, Lv, int*, Dag)")
    for name in ("(anonymous namespace)::hme_level0_kernel(G, Lv, int*, Dag)",
                 "void gang_level_kernel<32>(GangP)"):
        assert not lvl.search(name)
    for name in ("(anonymous namespace)::hme_level_kernel(G, Lv, Dag)",
                 "void gang_level0_kernel<32>(GangP)",
                 "isqrt_check_kernel(unsigned long long*)"):
        assert not lvl0.search(name)
