"""torch port: the base-level dataflow scheduler (csrc/hme_sched.cuh) and
the motion-search kernel sources (csrc/hme_search.cu, csrc/hme_gang.cu)
run on the host.

- The scheduler header, compiled by the host C++ compiler against a
  small CUDA shim (cuda::atomic_ref is std::atomic_ref, __nanosleep a
  yield) with a stub block body run by fewer OS threads than tickets,
  runs every block exactly once, each after its left, top and top-left
  neighbours, and never deadlocks: CIF, FHD, 352x16, 16x240 and 64x500
  in blocks of 16, and 8 CIF lanes in one launch.
- The kernel sources, compiled against the same shim with each warp an
  OS thread that runs its 32 lanes as fibers (a lane at a shuffle, ballot
  or barrier yields to the next; __syncthreads also meets the CTA's other
  warps at a std::barrier), equal the plain version (ops/hme_wave.py) on
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
import os
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from torch_parity import REPO, assert_same
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.ops import hme_gpu, hme_wave

CSRC = os.path.join(REPO, "dsv2_tpu_torch", "csrc")

SHIM = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(x)
#define __constant__
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct ShimCta {
  std::vector<uint8_t> smem;
  std::barrier<> bar;  // one arrival per warp
  ShimCta(size_t bytes, unsigned warps) : smem(bytes, 0xCD), bar(warps) {}
};
// Fiber switches: on x86-64 a stack switch that saves the callee-saved
// registers (no system call, unlike swapcontext's signal mask), elsewhere
// ucontext.
#if defined(__x86_64__)
extern "C" void shim_switch(void** from, void* to);
asm(R"(
  .text
  .hidden shim_switch
  .globl shim_switch
shim_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
)");
struct ShimCtx {
  void* sp = nullptr;
};
inline void shim_swap(ShimCtx& from, ShimCtx& to) { shim_switch(&from.sp, to.sp); }
inline void shim_make(ShimCtx& c, std::vector<char>& stack, void (*f)()) {
  auto top = (uintptr_t)(stack.data() + stack.size()) & ~(uintptr_t)15;
  void** sp = (void**)top;
  *--sp = nullptr;      // f's return address: it never returns
  *--sp = (void*)f;     // shim_switch returns into f
  for (int k = 0; k < 6; ++k) *--sp = nullptr;  // rbp rbx r12-r15
  c.sp = sp;
}
#else
struct ShimCtx {
  ucontext_t uc;
};
inline void shim_swap(ShimCtx& from, ShimCtx& to) { swapcontext(&from.uc, &to.uc); }
inline void shim_make(ShimCtx& c, std::vector<char>& stack, void (*f)()) {
  getcontext(&c.uc);
  c.uc.uc_stack.ss_sp = stack.data();
  c.uc.uc_stack.ss_size = stack.size();
  c.uc.uc_link = nullptr;
  makecontext(&c.uc, f, 0);
}
#endif
// A warp: one OS thread running its 32 lanes as fibers, switched at every
// collective (a lane waiting at one yields to the warp's scheduler).
struct ShimWarp {
  struct Lane {
    ShimCtx ctx;
    std::vector<char> stack;
    dim3 tid;
    bool done = false;
  };
  Lane lane[32];
  ShimCtx main;
  int cur = 0;
  unsigned arrived = 0, phase = 0;
  uint32_t v[32];
  dim3 bid, bdim, gdim;
  ShimCta* cta;
  std::function<void()> body;
};
inline thread_local ShimWarp* shim_w;
#define threadIdx (shim_w->lane[shim_w->cur].tid)
#define blockIdx (shim_w->bid)
#define blockDim (shim_w->bdim)
#define gridDim (shim_w->gdim)
inline int shim_sms = 2;  // the SMs the shim's device reports
inline uint8_t* shim_smem() { return shim_w->cta->smem.data(); }
// the 32 lanes meet; the last to arrive runs `last` first
template <class F> void shim_meet(F&& last) {
  ShimWarp& w = *shim_w;
  const unsigned ph = w.phase;
  if (++w.arrived == 32) {
    last();
    w.arrived = 0;
    ++w.phase;
    return;
  }
  while (w.phase == ph) shim_swap(w.lane[w.cur].ctx, w.main);
}
inline void shim_full(unsigned mask) {
  if (mask != 0xFFFFFFFFu) abort();  // whole warps only (Tile<32>)
}
inline void __syncthreads() {
  shim_meet([] { shim_w->cta->bar.arrive_and_wait(); });
}
inline void __syncwarp(unsigned m = 0xFFFFFFFFu) {
  shim_full(m);
  shim_meet([] {});
}
template <class T> T shim_read(T x, unsigned src) {
  ShimWarp& w = *shim_w;
  std::memcpy(&w.v[w.cur], &x, 4);
  shim_meet([] {});
  T r;
  std::memcpy(&r, &w.v[src & 31], 4);
  shim_meet([] {});
  return r;
}
template <class T> T __shfl_xor_sync(unsigned m, T x, int o, int = 32) {
  shim_full(m);
  return shim_read(x, shim_w->cur ^ o);
}
template <class T> T __shfl_sync(unsigned m, T x, int src, int = 32) {
  shim_full(m);
  return shim_read(x, src);
}
inline unsigned __ballot_sync(unsigned m, bool p) {
  shim_full(m);
  unsigned b = 0;
  for (int k = 0; k < 32; ++k)
    b |= (shim_read((unsigned)p, k) ? 1u : 0u) << k;
  return b;
}
inline int __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v ? __builtin_clz((unsigned)v) : 32; }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline float __uint2float_rn(unsigned n) { return (float)n; }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
template <class T> T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
namespace cuda {
enum thread_scope { thread_scope_device };
using std::memory_order_acquire;
using std::memory_order_relaxed;
using std::memory_order_release;
inline void atomic_thread_fence(std::memory_order o, thread_scope) {
  std::atomic_thread_fence(o);
}
template <class T, thread_scope S>
struct atomic_ref : std::atomic_ref<T> {
  using std::atomic_ref<T>::atomic_ref;
};
}  // namespace cuda
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = shim_sms;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline void shim_lane_main() {
  ShimWarp& w = *shim_w;
  w.body();
  w.lane[w.cur].done = true;
  shim_swap(w.lane[w.cur].ctx, w.main);  // never resumed
  abort();
}
// kernel<<<grid, block, smem, stream>>>(args): every warp of every CTA at
// once, an OS thread per warp
template <class... K, class... A>
cudaError_t shim_launch(void (*kern)(K...), dim3 grid, dim3 block,
                        size_t smem, cudaStream_t, A&&... args) {
  const unsigned G = grid.x, T = block.x, NW = T / 32;
  if (T % 32 || T > 1024 || smem > 232448) return cudaErrorInvalidValue;
  std::vector<std::unique_ptr<ShimCta>> ctas;
  for (unsigned g = 0; g < G; ++g) ctas.emplace_back(new ShimCta(smem, NW));
  std::vector<std::thread> th;
  for (unsigned g = 0; g < G; ++g)
    for (unsigned wi = 0; wi < NW; ++wi)
      th.emplace_back([&, g, wi] {
        auto w = std::make_unique<ShimWarp>();
        w->bid = dim3(g);
        w->bdim = dim3(T);
        w->gdim = dim3(G);
        w->cta = ctas[g].get();
        w->body = [&] { kern(args...); };
        shim_w = w.get();
        for (int l = 0; l < 32; ++l) {
          ShimWarp::Lane& ln = w->lane[l];
          ln.tid = dim3(wi * 32 + l);
          ln.stack.resize(1 << 18);
          shim_make(ln.ctx, ln.stack, shim_lane_main);
        }
        for (bool any = true; any;) {  // round robin over the live lanes
          any = false;
          for (int l = 0; l < 32; ++l) {
            if (w->lane[l].done) continue;
            any = true;
            w->cur = l;
            shim_swap(w->main, w->lane[l].ctx);
          }
        }
      });
  for (auto& x : th) x.join();
  return cudaSuccess;
}
"""

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


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    return cxx


def _write_shim(d):
    """The shim, and CUDA's cuda_runtime.h and cuda/atomic as the shim."""
    os.makedirs(os.path.join(d, "cuda"), exist_ok=True)
    for h, text in (("cuda_shim.h", SHIM),
                    ("cuda_runtime.h", '#include "cuda_shim.h"\n'),
                    ("cuda/atomic", '#include "cuda_shim.h"\n')):
        with open(os.path.join(d, h), "w") as f:
            f.write(text)


def _start_build(cxx, d, name, src):
    """Compile `src` (with the shim of d and csrc/ on the include path)
    into d/lib<name>.so in the background; returns (Popen, .so path)."""
    cpp, so = (os.path.join(d, name + e) for e in (".cpp", ".so"))
    with open(cpp, "w") as f:
        f.write(src)
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
           "-Wno-unknown-pragmas", "-I", d, "-I", CSRC, "-o", so, cpp]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def _finish(proc, so):
    out, _ = proc.communicate()
    if proc.returncode and "<barrier>" in out:
        pytest.skip("the host C++ compiler lacks C++20 <barrier>")
    assert proc.returncode == 0, out[-4000:]
    return ctypes.CDLL(so)


def _host_source(name):
    """csrc/<name>.cu for the shim (whose cuda_runtime.h and cuda/atomic
    are the shim): dynamic shared memory from the shim, launches through
    shim_launch."""
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = f.read()
    src, n = re.subn(r"extern __shared__ __align__\(16\) uint8_t smem\[\];",
                     "uint8_t* smem = shim_smem();", src)
    assert n >= 2
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(", r"shim_launch(\1, \2, ",
                     src, flags=re.S)
    assert n >= 2
    return '#include "cuda_shim.h"\n' + src


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The stub scheduler and csrc/hme_search.cu and hme_gang.cu, built for
    the host against the shim (three compiles at once)."""
    cxx = _cxx()
    d = str(tmp_path_factory.mktemp("hme_host"))
    _write_shim(d)
    jobs = {"stub": _start_build(cxx, d, "stub", STUB)}
    for name in ("hme_search", "hme_gang"):
        jobs[name] = _start_build(cxx, d, name, _host_source(name))
    libs = {k: _finish(*v) for k, v in jobs.items()}
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {("stub", "sched_stub"): [I] * 4 + [P] * 3,
            ("hme_search", "dsv2t_hme_level"): [P] * 9,
            ("hme_search", "dsv2t_hme_level0"): [P] * 13 + [I, P, P],
            ("hme_gang", "dsv2t_hme_gang"): [I, I, I, P, P, P, P, I, P]}
    fns = {}
    for (lib, fn), argtypes in sigs.items():
        f = getattr(libs[lib], fn)
        f.restype = I
        f.argtypes = argtypes
        fns[fn] = f
    return fns


def _in_time(fn, timeout=600):
    """fn() in a thread that must end within `timeout` s (a warp of the
    host build is 32 OS threads meeting at a barrier per collective, so a
    loaded machine slows it many times over)."""
    box = {}

    def target():
        box["rc"] = fn()
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "hung"
    return box["rc"]


# (label, nbh, nbv, lanes): blocks of 16 over CIF, FHD, 352x16, 16x240,
# 64x500, and 8 CIF lanes in one launch
DAGS = [("cif", 22, 18, 1), ("fhd", 120, 68, 1), ("352x16", 22, 1, 1),
        ("16x240", 1, 15, 1), ("64x500", 4, 32, 1), ("cif_x8", 22, 18, 8)]


@pytest.mark.parametrize("threads", [3, 7])
@pytest.mark.parametrize("label,nbh,nbv,lanes", DAGS,
                         ids=[d[0] for d in DAGS])
def test_scheduler_order(host, label, nbh, nbv, lanes, threads):
    n = lanes * nbv * nbh
    assert threads < n
    scratch = torch.zeros(1 + n, dtype=torch.int32)
    runs = torch.zeros(n, dtype=torch.int32)
    bad = torch.zeros(1, dtype=torch.int32)
    rc = _in_time(lambda: host["sched_stub"](
        nbh, nbv, lanes, threads, scratch.data_ptr(), runs.data_ptr(),
        bad.data_ptr()))
    assert rc == 0
    assert torch.equal(runs, torch.ones(n, dtype=torch.int32))
    assert int(bad) == 0
    assert int(scratch[0]) == n + threads   # each worker's last ticket
    assert torch.equal(scratch[1:], torch.ones(n, dtype=torch.int32))


def _np(t):
    return ctypes.c_void_p(t.data_ptr())


def _level0_host(fn, cfg, inputs, parent, gxy, workers):
    """Kernel 5 of the host build on CPU tensors (ops/hme_gpu.hme_level0's
    arguments)."""
    sp, rp, op, su, sv, ru, rv, tmx, tmy, quant, skt = inputs
    tmv = torch.stack([tmx, tmy]).contiguous()
    out = torch.zeros((hme_gpu.NF0, cfg.nbv, cfg.nbh), dtype=torch.int32)
    sums = torch.zeros(4, dtype=torch.int32)
    geom = hme_gpu.geometry(cfg, 0, [sp[0]], [su, sv], int(quant), int(skt))
    sched = hme_gpu._sched(cfg, 1, "cpu")
    rc = _in_time(lambda: fn(
        *(_np(t) for t in (sp[0], rp[0], op[0], su, sv, ru, rv, parent, tmv,
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
        rc = _in_time(lambda: host["dsv2t_hme_level"](
            *(_np(t) for t in (sp[level], rp[level], op[level], parent, tmv,
                               gxy, got)), geom.ctypes.data, None))
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
        sched = hme_gpu._sched(cfg, n, "cpu") if level == 0 else None
        rc = _in_time(lambda: fn(
            int(level == 0), 32, n, geom.ctypes.data, ptrs.ctypes.data,
            scal.ctypes.data, None if sched is None else _np(sched), 2,
            None))
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
