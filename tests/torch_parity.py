"""Parity helpers for the torch port's tests (tests/test_torch_*.py).

The same numpy input goes through a `dsv2_tpu` function (JAX on the CPU)
and its `dsv2_tpu_torch` counterpart; the outputs must agree bit for bit,
dtype included. Every value on the ported path is an integer, so no
tolerance applies.

Also the host build of the motion-search kernel sources
(csrc/hme_search.cu, csrc/hme_gang.cu and the scheduler header), compiled
by the host C++ compiler against a small CUDA shim (`hme_host_build`):
each warp an OS thread that runs its 32 lanes as fibers, a lane at a
shuffle, ballot or barrier of its tile (8, 16 or 32 lanes) yielding to
the next; __syncthreads also meets the CTA's other warps at a
std::barrier; cuda::atomic_ref is std::atomic_ref, __nanosleep a yield.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

os.environ.setdefault("DSV2_TORCH_DEVICE", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))  # torch_port_golden
CSRC = os.path.join(REPO, "dsv2_tpu_torch", "csrc")


def to_np(x):
    """jax array, torch tensor or numpy array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what="output"):
    """Bit-exact equality, dtype included, recursing into tuples/lists."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "%s[%d]" % (what, i))
        return
    g, w = to_np(got), to_np(want)
    assert g.dtype == w.dtype, "%s dtype %s != %s" % (what, g.dtype, w.dtype)
    assert g.shape == w.shape, "%s shape %s != %s" % (what, g.shape, w.shape)
    if not np.array_equal(g, w):
        bad = np.argwhere(g != w)
        i = tuple(bad[0])
        raise AssertionError("%s differs at %d positions, first %s: %s != %s"
                             % (what, len(bad), i, g[i], w[i]))


def tt(a):
    """numpy -> CPU torch tensor (copy)."""
    return torch.from_numpy(np.array(a))


HME_SHIM = r"""
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
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
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
// A fiber's stack, left uninitialised: a lane touches only the pages it
// uses, so a launch of many warps stays small.
struct ShimStack {
  std::unique_ptr<char[]> p;
  size_t n = 0;
  char* data() { return p.get(); }
  size_t size() const { return n; }
  void resize(size_t k) {
    p.reset(new char[k]);
    n = k;
  }
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
inline void shim_make(ShimCtx& c, ShimStack& stack, void (*f)()) {
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
inline void shim_make(ShimCtx& c, ShimStack& stack, void (*f)()) {
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
    ShimStack stack;
    dim3 tid;
    bool done = false;
  };
  Lane lane[32];
  ShimCtx main;
  int cur = 0;
  unsigned arrived[64] = {}, phase[64] = {};  // per group of lanes
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
// the lanes of `mask` (a tile: 8, 16 or 32 aligned lanes, the caller
// among them) meet; the last to arrive runs `last` first
template <class F> void shim_meet(unsigned mask, F&& last) {
  ShimWarp& w = *shim_w;
  const int n = __builtin_popcount(mask);
  const int g = __builtin_ctz(mask) + (n == 32 ? 32 : 0);
  if (!((mask >> w.cur) & 1)) abort();
  const unsigned ph = w.phase[g];
  if (++w.arrived[g] == (unsigned)n) {
    last();
    w.arrived[g] = 0;
    ++w.phase[g];
    return;
  }
  while (w.phase[g] == ph) shim_swap(w.lane[w.cur].ctx, w.main);
}
inline void __syncthreads() {
  shim_meet(0xFFFFFFFFu, [] { shim_w->cta->bar.arrive_and_wait(); });
}
inline void __syncwarp(unsigned m = 0xFFFFFFFFu) { shim_meet(m, [] {}); }
template <class T> T shim_read(unsigned m, T x, unsigned src) {
  ShimWarp& w = *shim_w;
  std::memcpy(&w.v[w.cur], &x, 4);
  shim_meet(m, [] {});
  T r;
  std::memcpy(&r, &w.v[src & 31], 4);
  shim_meet(m, [] {});
  return r;
}
template <class T> T __shfl_xor_sync(unsigned m, T x, int o, int = 32) {
  return shim_read(m, x, shim_w->cur ^ o);
}
template <class T> T __shfl_up_sync(unsigned m, T x, unsigned d, int width = 32) {
  const int l = shim_w->cur, base = l & ~(width - 1);
  return shim_read(m, x, l - (int)d >= base ? l - d : l);
}
template <class T> T __shfl_sync(unsigned m, T x, int src, int width = 32) {
  return shim_read(m, x, (shim_w->cur & ~(width - 1)) | (src & (width - 1)));
}
inline unsigned __ballot_sync(unsigned m, bool p) {
  ShimWarp& w = *shim_w;
  w.v[w.cur] = p;
  shim_meet(m, [] {});
  unsigned b = 0;
  for (int k = 0; k < 32; ++k)
    if ((m >> k) & 1) b |= (w.v[k] ? 1u : 0u) << k;
  shim_meet(m, [] {});
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


def _cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    return cxx


def _write_shim(d):
    """The shim, and CUDA's cuda_runtime.h and cuda/atomic as the shim."""
    os.makedirs(os.path.join(d, "cuda"), exist_ok=True)
    for h, text in (("cuda_shim.h", HME_SHIM),
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


def in_time(fn, timeout=600):
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


def ptr(t):
    """A tensor's data pointer for a ctypes call."""
    return ctypes.c_void_p(t.data_ptr())


P_, I_ = ctypes.c_void_p, ctypes.c_int
# the C entries of the motion-search sources and their argument types
HME_ENTRIES = {("hme_search", "dsv2t_hme_level"): [P_] * 8 + [I_, P_, P_],
               ("hme_search", "dsv2t_hme_level0"): [P_] * 13 + [I_, P_, P_],
               ("hme_gang", "dsv2t_hme_gang"): [I_, I_, I_, P_, P_, P_, P_,
                                                I_, P_]}


def hme_host_build(d, extra=None):
    """csrc/hme_search.cu and hme_gang.cu (and `extra`: {name: (C++
    source, {entry: argtypes})}) built for the host against the shim in
    directory d, all compiles at once; returns {entry: ctypes function}."""
    cxx = _cxx()
    _write_shim(d)
    extra = extra or {}
    jobs = {name: _start_build(cxx, d, name, src)
            for name, (src, _) in extra.items()}
    for name in ("hme_search", "hme_gang"):
        jobs[name] = _start_build(cxx, d, name, _host_source(name))
    libs = {k: _finish(*v) for k, v in jobs.items()}
    sigs = dict(HME_ENTRIES)
    for name, (_, entries) in extra.items():
        sigs.update(((name, fn), a) for fn, a in entries.items())
    fns = {}
    for (lib, fn), argtypes in sigs.items():
        f = getattr(libs[lib], fn)
        f.restype = I_
        f.argtypes = argtypes
        fns[fn] = f
    return fns
