"""torch port: the motion search's dataflow scheduler (csrc/hme_sched.cuh)
and the motion-search kernel sources (csrc/hme_search.cu,
csrc/hme_gang.cu) run on the host.

- The scheduler header, compiled by the host C++ compiler against a
  small CUDA shim (tests/torch_parity.py; cuda::atomic_ref is
  std::atomic_ref, __nanosleep a yield) with a stub block body run by
  fewer OS threads than tickets, runs every block exactly once, each
  after its left, top and top-left neighbours, and never deadlocks: CIF,
  FHD, 352x16, 16x240 and 64x500 in blocks of 16, 8 CIF lanes in one
  launch, and the upper-level grids of FHD level 1 and 8 CIF lanes.
- The kernel sources, compiled against the same shim with each warp an
  OS thread that runs its 32 lanes as fibers (a lane at a shuffle, ballot
  or barrier yields to the next; __syncthreads also meets the CTA's other
  warps at a std::barrier), every level on the scheduler with 2 workers,
  equal the plain version (ops/hme_wave.py) on
  every field and sum, level by level, on seeded inputs: kernels 4/5
  with and without temporal candidates at efforts 10, 8, 5 and 0, on
  nano, odd and 4:2:2 geometries, lossless 4:4:4, 32x32 blocks and the
  three extreme geometries 352x16, 16x240 and 64x500 4:1:1; kernels 6/7
  on 3 lanes.
  This runs the scheduler, the split of a block's search around the wait
  for its neighbours, the batched metrics, the staged windows and the
  exact square root here; only the card shows that nvcc takes them and
  how fast they run (tests/test_torch_cuda.py, chip_smoke.py).
- The exact square root's arithmetic (float root, one integer step each
  way) in numpy on the edge cases and a seeded sample.
"""
import ctypes

import numpy as np
import pytest
import torch

from torch_parity import assert_same, hme_host_build, in_time, ptr
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.ops import hme_gpu, hme_wave

STUB = r"""
#include "cuda_shim.h"
#include "hme_sched.cuh"
struct HostTile {  // a worker of one thread
  static int lane() { return 0; }
  static int bcast0(int v) { return v; }
  static void tile_sync() {}
};
// run_dag over lanes x nbv x nbh blocks on `threads` OS threads; runs[b]
// counts block b's bodies; bad counts bodies that found their left, top or
// top-left neighbour not yet run
extern "C" int sched_stub(int nbh, int nbv, int lanes, int threads,
                          int* scratch, int* runs, int* bad) {
  const Dag g{nbh, nbv, lanes, scratch, scratch + 1};
  std::vector<std::thread> th;
  for (int t = 0; t < threads; ++t)
    th.emplace_back([&] {
      run_dag<HostTile>(g, [&](int ln, int i, int j, auto&& wait) {
        wait();
        int* done = runs + ln * nbv * nbh;
        auto ran = [&](int x, int y) {
          return std::atomic_ref<int>(done[y * nbh + x]).load() > 0;
        };
        if ((i > 0 && !ran(i - 1, j)) || (j > 0 && !ran(i, j - 1)) ||
            (i > 0 && j > 0 && !ran(i - 1, j - 1)))
          std::atomic_ref<int>(*bad).fetch_add(1);
        std::this_thread::yield();
        std::atomic_ref<int>(done[j * nbh + i]).fetch_add(1);
      });
    });
  for (auto& x : th) x.join();
  return 0;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The stub scheduler and csrc/hme_search.cu and hme_gang.cu, built for
    the host against the shim (three compiles at once)."""
    return hme_host_build(str(tmp_path_factory.mktemp("hme_host")), {
        "stub": (STUB, {"sched_stub": [ctypes.c_int] * 4
                        + [ctypes.c_void_p] * 3})})


# (label, nbh, nbv, lanes): blocks of 16 over CIF, FHD, 352x16, 16x240,
# 64x500, and 8 CIF lanes in one launch; the upper-level grids of FHD
# level 1 (60 x 34 blocks at a step of 2) and of 8 CIF lanes at level 1
DAGS = [("cif", 22, 18, 1), ("fhd", 120, 68, 1), ("352x16", 22, 1, 1),
        ("16x240", 1, 15, 1), ("64x500", 4, 32, 1), ("cif_x8", 22, 18, 8),
        ("fhd_level1", 60, 34, 1), ("cif_level1_x8", 11, 9, 8)]


@pytest.mark.parametrize("threads", [3, 7])
@pytest.mark.parametrize("label,nbh,nbv,lanes", DAGS,
                         ids=[d[0] for d in DAGS])
def test_scheduler_order(host, label, nbh, nbv, lanes, threads):
    n = lanes * nbv * nbh
    assert threads < n
    scratch = torch.zeros(1 + n, dtype=torch.int32)
    runs = torch.zeros(n, dtype=torch.int32)
    bad = torch.zeros(1, dtype=torch.int32)
    rc = in_time(lambda: host["sched_stub"](
        nbh, nbv, lanes, threads, scratch.data_ptr(), runs.data_ptr(),
        bad.data_ptr()))
    assert rc == 0
    assert torch.equal(runs, torch.ones(n, dtype=torch.int32))
    assert int(bad) == 0
    assert int(scratch[0]) == n + threads   # each worker's last ticket
    assert torch.equal(scratch[1:], torch.ones(n, dtype=torch.int32))


def _level0_host(fn, cfg, inputs, parent, gxy, workers):
    """Kernel 5 of the host build on CPU tensors (ops/hme_gpu.hme_level0's
    arguments)."""
    sp, rp, op, su, sv, ru, rv, tmx, tmy, quant, skt = inputs
    tmv = torch.stack([tmx, tmy]).contiguous()
    out = torch.zeros((hme_gpu.NF0, cfg.nbv, cfg.nbh), dtype=torch.int32)
    sums = torch.zeros(4, dtype=torch.int32)
    geom = hme_gpu.geometry(cfg, 0, [sp[0]], [su, sv], int(quant), int(skt))
    sched = hme_gpu._sched(cfg, 1, "cpu")
    rc = in_time(lambda: fn(
        *(ptr(t) for t in (sp[0], rp[0], op[0], su, sv, ru, rv, parent, tmv,
                           gxy, out, sums, sched)),
        workers, geom.ctypes.data, None))
    assert rc == 0
    return out, sums


# (input, has_tmv, effort, hme_case keywords): nano, odd and 4:2:2
# geometries, efforts 10, 8, 5 and 0, lossless 4:4:4, 32x32 blocks, and
# the three extreme geometries of tests/test_edge_dims.py
HOST_CASES = [("nano48x32_420_4f", False, 10, {}),
              ("nano48x32_420_4f", True, 5, {}),
              ("odd100x62_420_4f", True, 10, {}),
              ("odd100x62_420_4f", False, 0, {}),
              ("tiny64x48_422_4f", True, 8, {}),
              ("tiny64x48_444_4f", True, 10, dict(lossless=True, quant=1)),
              ("tiny64x48_420_6f", True, 10, dict(blk=32)),
              ("synth352x16_420", True, 10, {}),
              ("synth16x240_420", False, 10, {}),
              ("synth64x500_411", True, 10, {})]


@pytest.mark.parametrize("name,has_tmv,effort,kw", HOST_CASES,
                         ids=["%s-tmv%d-e%d%s" % (c[0], c[1], c[2], "".join(
                             "-%s%s" % kv for kv in c[3].items()))
                             for c in HOST_CASES])
def test_search_source_on_host(host, name, has_tmv, effort, kw):
    """Kernels 4 and 5 (csrc/hme_search.cu) of the host build against the
    plain version, level by level from the same parent field."""
    frames, meta = read_y4m(golden.input_path(name))
    cfgd, inputs = golden.hme_case(frames, meta, has_tmv=has_tmv,
                                   effort=effort, **kw)
    cfg = hme_wave.WaveCfg(**cfgd)
    sp, rp, op, su, sv, ru, rv, tmx, tmy, quant, skt = inputs
    tmv = torch.stack([tmx, tmy]).contiguous()
    gxy = torch.zeros(2, dtype=torch.int32)
    parent = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32)
    for level in range(cfg.pyramid_levels, 0, -1):
        got = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32)
        geom = hme_gpu.geometry(cfg, level, [sp[level]], [], int(quant), 0)
        sched = hme_gpu._sched(cfg, 1, "cpu", level)
        rc = in_time(lambda: host["dsv2t_hme_level"](
            *(ptr(t) for t in (sp[level], rp[level], op[level], parent, tmv,
                               gxy, got, sched)), 2, geom.ctypes.data, None))
        assert rc == 0
        want = torch.stack(hme_wave.refine_level_graph(
            cfg, level, sp[level], rp[level], op[level], parent[0],
            parent[1], tmx, tmy, gxy[0], gxy[1], int(quant)))
        assert_same(got, want, "level %d" % level)
        parent = got
        gxy = torch.stack(hme_wave.global_motion_graph(cfg, level, got[0],
                                                       got[1]))
    st = hme_wave.refine_level0_graph(
        cfg, (sp[0], su, sv), (rp[0], ru, rv), op[0], parent[0], parent[1],
        tmx, tmy, gxy[0], gxy[1], int(quant), int(skt))
    want = torch.stack([st[k] for k in hme_wave.FIELDS0]
                       + [st["fskip"].int()])
    wsum = torch.stack([st[k] for k in hme_wave.SUMS0])
    # one warp (small levels only: it runs every block in turn); two CTAs
    # of one warp each
    for workers in (1, 2) if cfg.nbv * cfg.nbh <= 64 else (2,):
        out, sums = _level0_host(host["dsv2t_hme_level0"], cfg, inputs,
                                 parent, gxy, workers)
        assert_same(out, want, "level 0 fields, %d workers" % workers)
        assert_same(sums, wsum, "level 0 sums")


def test_gang_source_on_host(host):
    """Kernels 6 and 7 (csrc/hme_gang.cu) of the host build on 3 seeded
    nano lanes in one launch per level, against the plain version lane
    by lane."""
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    cfgd, lanes = golden.hme_lanes(frames, meta, 3, has_tmv=True, effort=10)
    cfg = hme_wave.WaveCfg(**cfgd)
    n = len(lanes)
    tmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]
                      ).contiguous()
    quants = [int(ln[9]) for ln in lanes]
    skts = [int(ln[10]) for ln in lanes]
    gxy = torch.zeros((n, 2), dtype=torch.int32)
    parent = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32)
    fn = host["dsv2t_hme_gang"]
    for level in range(cfg.pyramid_levels, -1, -1):
        planes = [([ln[k][level] for k in range(3)],
                   list(ln[3:7]) if level == 0 else []) for ln in lanes]
        nf = hme_gpu.NF0 if level == 0 else 2
        out = torch.zeros((n, nf, cfg.nbv, cfg.nbh), dtype=torch.int32)
        sums = torch.zeros((n, 4), dtype=torch.int32) if level == 0 else None
        geom, ptrs, scal = hme_gpu._gang_args(
            cfg, level, planes, parent, tmv, gxy, out, sums, quants,
            skts if level == 0 else [0] * n, 1)
        sched = hme_gpu._sched(cfg, n, "cpu", level)
        rc = in_time(lambda: fn(
            int(level == 0), 32, n, geom.ctypes.data, ptrs.ctypes.data,
            scal.ctypes.data, ptr(sched), 2, None))
        assert rc == 0
        for i, ln in enumerate(lanes):
            if level:
                want = torch.stack(hme_wave.refine_level_graph(
                    cfg, level, ln[0][level], ln[1][level], ln[2][level],
                    parent[i, 0], parent[i, 1], tmv[i, 0], tmv[i, 1],
                    gxy[i, 0], gxy[i, 1], quants[i]))
                assert_same(out[i], want, "lane %d level %d" % (i, level))
                continue
            st = hme_wave.refine_level0_graph(
                cfg, (ln[0][0],) + tuple(ln[3:5]),
                (ln[1][0],) + tuple(ln[5:7]), ln[2][0], parent[i, 0],
                parent[i, 1], tmv[i, 0], tmv[i, 1], gxy[i, 0], gxy[i, 1],
                quants[i], skts[i])
            want = torch.stack([st[k] for k in hme_wave.FIELDS0]
                               + [st["fskip"].int()])
            assert_same(out[i], want, "lane %d level 0" % i)
            assert_same(sums[i], torch.stack([st[k] for k in
                                              hme_wave.SUMS0]), "sums")
        if level:
            parent = out
            gxy = torch.stack([torch.stack(hme_wave.global_motion_graph(
                cfg, level, out[i, 0], out[i, 1])) for i in range(n)])


def isqrt_fast(n):
    """csrc/hme_block.cuh isqrt_u32 in numpy: the float32 root of the
    float32-rounded input, clamped to 65535, one integer step each way."""
    n = np.asarray(n, dtype=np.uint64)
    r = np.minimum(np.sqrt(n.astype(np.float32)).astype(np.uint64), 65535)
    r = np.where(r * r > n, r - 1, r)
    return np.where((r + 1) * (r + 1) <= n, r + 1, r)


def test_isqrt_exact():
    """Exact floor square roots on k^2 - 1, k^2, k^2 + 2k for every k
    that keeps them in uint32, 2^32 - 1, and a seeded sample."""
    k = np.arange(1, 65536, dtype=np.uint64)
    edges = np.concatenate([k * k - 1, k * k, k * k + 2 * k,
                            [0, 2**32 - 1, 2**32 - 2]]).astype(np.uint64)
    edges = edges[edges < 2**32]
    sample = np.random.default_rng(5).integers(0, 2**32, 1 << 20,
                                               dtype=np.uint64)
    for n in (edges, sample):
        r = isqrt_fast(n)
        assert np.all(r * r <= n) and np.all((r + 1) * (r + 1) > n)
    assert int(isqrt_fast(2**32 - 1)) == 65535
