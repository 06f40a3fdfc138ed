"""torch port: the shared-memory plan of the in-loop filter wavefront
kernel (ops/filters.wavefront_plan), the facts its design rests on, and
the kernel source itself run on the host.

- every layout the codec produces up to 3840x2160, in all five chroma
  formats with blocks of 16 and 32, has a plan within one H100 CTA's
  232,448 shared bytes per CTA and 8 CTAs per cluster; malformed layouts
  raise; a plane no cluster holds (very tall ones, 16K 4:4:4) gets the
  plan with its ring rows in global memory instead;
- the plain wavefront keeps every plane value, margins included, in
  [0, 255], which lets the kernel hold the plane and the windows as uint8;
- U and V stacked into one chroma call equal two calls;
- csrc/wavefront_filter.cu, compiled by the host C++ compiler against a
  small CUDA shim (each CUDA thread an OS thread, each barrier a
  std::barrier, each CTA's shared memory a buffer of garbage, distributed
  shared memory a pointer into the other CTA's buffer), equals the plain
  version on seeded planes, with lanes looped over threads and with
  clusters of 2 to 8 CTAs, and, with the ring forced into a global
  scratch (windows in shared memory or after the ring), equals the
  native C filters for every kind. This runs the kernel's ring, skew, write-back
  and cluster logic here; only the card shows that nvcc takes it and
  how fast it runs (tests/test_torch_cuda.py, chip_smoke.py).
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from torch_parity import REPO, assert_same
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.core.frame import plane_dims
from dsv2_tpu_torch.ops import _kernels, filters

FORMATS = {"444": K.SUBSAMP_444, "422": K.SUBSAMP_422, "420": K.SUBSAMP_420,
           "411": K.SUBSAMP_411, "410": K.SUBSAMP_410}
SIZES = [(48, 32), (64, 48), (100, 62), (176, 144), (352, 288), (16, 240),
         (352, 16), (64, 500), (1280, 720), (1920, 1080), (2560, 1440),
         (3840, 2160)]


def _layouts(w, h, subsamp, blk):
    """The wavefront layouts the codec's filters build for a w x h frame
    with blk x blk blocks: intra/luma (4x4 tiles) and chroma (blocks)."""
    nbh, nbv = -(-w // blk), -(-h // blk)
    out = []
    ntx, nty, _, _ = filters._tile_maps(w, h, nbh, nbv)
    if ntx > 0 and nty > 0:
        out.append(filters._layout(w, h, 4, 4, ntx, nty))
    cw, ch = plane_dims(subsamp, w, h)[1]
    bw, bh = blk >> K.fmt_h_shift(subsamp), blk >> K.fmt_v_shift(subsamp)
    if cw >= 8 and ch >= 8:
        out.append(filters._layout(cw, ch, bw, bh, nbh, nbv))
    return out


@pytest.mark.parametrize("blk", [16, 32])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("w,h", SIZES, ids=["%dx%d" % s for s in SIZES])
def test_plan_takes_every_layout(w, h, fmt, blk):
    lays = _layouts(w, h, FORMATS[fmt], blk)
    assert lays
    for lay in lays:
        plan = filters.wavefront_plan(lay)
        assert plan.storage == "uint8" and plan.R == 6 * lay.tw + 8
        assert plan.ring == "shared" and plan.scratch == 0
        assert plan.smem <= filters.SMEM_OPTIN and plan.C <= 8, plan
        assert 32 <= plan.threads <= filters.WF_MAX_THREADS
        assert plan.threads % 32 == 0
        assert plan.J * plan.C >= lay.nty > plan.J * (plan.C - 1)
        assert plan.LC == min(lay.L, plan.J)
        assert (plan.wstride // 4) % 2 == 1
        assert plan.wstride >= lay.wh * lay.ww
        # the fewest CTAs that fit
        for c in filters.WF_CLUSTERS[:filters.WF_CLUSTERS.index(plan.C)]:
            try:
                small = filters.wavefront_plan(lay, cluster=c)
            except ValueError:
                continue
            assert small.smem > filters.SMEM_OPTIN
        geom = _kernels.wavefront_geom(lay, 5, plan)
        assert geom.shape == (25,) and geom[14] == 5
        assert list(geom[23:]) == [0, 0]
    if (w, h, fmt, blk) == (3840, 2160, "444", 32):
        assert [filters.wavefront_plan(x).C for x in lays] == [1, 4]
    if (w, h, fmt, blk) == (2560, 1440, "444", 32):
        assert [filters.wavefront_plan(x).C for x in lays] == [1, 2]


_GOOD = filters._layout(40, 28, 4, 4, 9, 6)


@pytest.mark.parametrize("change", [
    dict(tw=6, ww=14), dict(th=2, wh=10), dict(tw=64, ww=72), dict(mr=4),
    dict(mr=6),
    dict(mc=6), dict(wh=13), dict(L=2), dict(nd=7), dict(HP=20),
    dict(WP=30), dict(ntx=0), "huge", "cluster3", "cluster_too_big",
    "global_cluster", "ring_kind"])
def test_plan_rejects(change):
    if change == "huge":     # 16K 4:4:4 32x32 chroma: no cluster holds it
        lay = filters._layout(15360, 8640, 32, 32, 480, 270)
        with pytest.raises(ValueError, match="no cluster"):
            filters.wavefront_plan(lay, ring="shared")
    elif change == "cluster3":
        with pytest.raises(ValueError, match="no cluster of 3"):
            filters.wavefront_plan(_GOOD, cluster=3)
    elif change == "cluster_too_big":   # 6 tile rows over 8 CTAs
        with pytest.raises(ValueError, match="do not fill"):
            filters.wavefront_plan(_GOOD, cluster=8)
    elif change == "global_cluster":
        with pytest.raises(ValueError, match="one CTA"):
            filters.wavefront_plan(_GOOD, cluster=2, ring="global")
    elif change == "ring_kind":
        with pytest.raises(ValueError, match="no ring"):
            filters.wavefront_plan(_GOOD, ring="local")
    else:
        with pytest.raises(ValueError, match="malformed"):
            filters.wavefront_plan(_GOOD._replace(**change))


# (w, h, format, block): the planes no cluster of 8 CTAs holds in shared
# memory (their chroma), and 16K 4:4:4, whose lane windows alone exceed
# one CTA's shared memory
TALL = [(16, 16384, "444", 32), (64, 16384, "444", 32),
        (16, 32768, "444", 16), (16, 32768, "422", 32),
        (15360, 8640, "444", 32)]


@pytest.mark.parametrize("w,h,fmt,blk", TALL,
                         ids=["%dx%d_%s_b%d" % c for c in TALL])
def test_plan_global_ring(w, h, fmt, blk):
    """A layout no cluster holds gets the global ring on one CTA, the
    ring's bytes in the scratch; the luma layouts keep a shared plan."""
    luma, chroma = _layouts(w, h, FORMATS[fmt], blk)
    assert filters.wavefront_plan(luma).ring == "shared"
    with pytest.raises(ValueError, match="no cluster"):
        filters.wavefront_plan(chroma, ring="shared")
    plan = filters.wavefront_plan(chroma)
    assert plan == filters.wavefront_plan(chroma, ring="global")
    assert (plan.ring, plan.C, plan.J, plan.rows) == ("global", 1,
                                                      chroma.nty, chroma.HP)
    wins = plan.LC * plan.wstride
    ring = filters._ring_bytes(chroma, plan.rows)
    assert plan.smem in (0, wins) and plan.smem <= filters.SMEM_OPTIN
    assert plan.scratch % 16 == 0
    assert plan.scratch >= ring + (0 if plan.smem else wins)
    assert (plan.smem == 0) == ((w, h) == (15360, 8640))
    geom = _kernels.wavefront_geom(chroma, 5, plan)
    assert list(geom[23:]) == [1, plan.scratch]


def _record_plain(monkeypatch):
    """Route every wavefront call to the plain version and keep each
    padded plane (margins included) after it ran."""
    seen = []
    plain = filters.wavefront_filter_plain

    def rec(kind, lay, plane, props, scal):
        before = plane.clone()
        plain(kind, lay, plane, props, scal)
        seen.append((kind, before, plane.clone()))
        return plane
    monkeypatch.setattr(filters, "wavefront_filter", rec)
    return seen


@pytest.mark.parametrize("kind", filters.KINDS)
def test_plain_value_range(kind, monkeypatch):
    """Every value the wavefront holds stays in [0, 255] at CIF (the
    kernel's uint8 ring and windows rely on it), margins included."""
    seen = _record_plain(monkeypatch)
    for seed in (1, 2):
        args = golden.filter_case(kind, 352, 288, 16, seed=seed, nb=2)
        getattr(filters, kind + "_filter_graph")(*args)
    assert len(seen) == 2
    for _, before, after in seen:
        assert not torch.equal(before, after)
        assert int(after.min()) >= 0 and int(after.max()) <= 255


def test_chroma_uv_one_call():
    """U and V stacked into one chroma_filter_graph call (the motion
    grids broadcast over the stack) equal two single calls."""
    w, h, nbh, nbv, bw, bh, vis, mvx, mvy, flags, q = golden.filter_case(
        "chroma", 352, 288, 16, seed=9, nb=2)
    q = int(q[0])
    one = [filters.chroma_filter_graph(w, h, nbh, nbv, bw, bh, vis[c],
                                       mvx[0], mvy[0], flags[0], q)
           for c in range(2)]
    both = filters.chroma_filter_graph(w, h, nbh, nbv, bw, bh, vis, mvx[0],
                                       mvy[0], flags[0], q)
    assert both.shape == vis.shape
    assert_same(both, torch.stack(one))
    assert not torch.equal(both, vis)


_SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(x)
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline void __threadfence_block() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline thread_local dim3 blockIdx, threadIdx, blockDim;
struct ShimCta { uint8_t* smem; size_t bytes; std::barrier<>* bar; };
inline thread_local ShimCta* shim_ctas;
inline thread_local unsigned shim_rank;
inline thread_local std::barrier<>* shim_cbar;
inline uint8_t* shim_smem() { return shim_ctas[shim_rank].smem; }
inline void __syncthreads() { shim_ctas[shim_rank].bar->arrive_and_wait(); }
namespace cooperative_groups {
struct cluster_group {
  void sync() { shim_cbar->arrive_and_wait(); }
  unsigned block_rank() { return shim_rank; }
  template <class T> T* map_shared_rank(T* p, unsigned k) {
    size_t off = (uint8_t*)p - shim_ctas[shim_rank].smem;
    if (off >= shim_ctas[shim_rank].bytes) abort();
    return (T*)(shim_ctas[k].smem + off);
  }
};
inline cluster_group this_cluster() { return cluster_group(); }
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448;
  return cudaSuccess;
}
template <class... K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kern)(K...), A&&... args) {
  unsigned C = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      C = cfg->attrs[a].val.clusterDim.x;
  const unsigned T = cfg->blockDim.x, G = cfg->gridDim.x;
  if (G % C) return cudaErrorInvalidConfiguration;
  for (unsigned c0 = 0; c0 < G; c0 += C) {
    std::vector<std::vector<uint8_t>> bufs(C);
    std::deque<std::barrier<>> bars;   // barriers do not move
    std::vector<ShimCta> ctas(C);
    for (unsigned k = 0; k < C; ++k) {
      bufs[k].assign(cfg->dynamicSmemBytes, 0xCD);
      bars.emplace_back(T);
      ctas[k] = ShimCta{bufs[k].data(), bufs[k].size(), &bars[k]};
    }
    std::barrier<> cbar(C * T);
    std::vector<std::thread> th;
    for (unsigned k = 0; k < C; ++k)
      for (unsigned t = 0; t < T; ++t)
        th.emplace_back([&, k, t] {
          blockIdx = dim3(c0 + k);
          threadIdx = dim3(t);
          blockDim = dim3(T);
          shim_ctas = ctas.data();
          shim_rank = k;
          shim_cbar = &cbar;
          kern(args...);
        });
    for (auto& x : th) x.join();
  }
  return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/wavefront_filter.cu built for the host against _SHIM."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("wavefront_host")
    with open(os.path.join(REPO, "dsv2_tpu_torch", "csrc",
                           "wavefront_filter.cu")) as f:
        src = f.read()
    src, n = re.subn(r"#include <(cooperative_groups|cuda_runtime)\.h>\n",
                     "", src)
    assert n == 2
    src, n = re.subn(r"extern __shared__ __align__\(16\) uint8_t smem\[\];",
                     "uint8_t* smem = shim_smem();", src)
    assert n == 1
    with open(d / "cuda_shim.h", "w") as f:
        f.write(_SHIM)
    with open(d / "wf.cpp", "w") as f:
        f.write('#include "cuda_shim.h"\n' + src)
    so = str(d / "libwf.so")
    res = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                          "-pthread", "-Wno-unknown-pragmas", "-I", str(d),
                          "-o", so, str(d / "wf.cpp")],
                         capture_output=True, text=True)
    if res.returncode and "<barrier>" in res.stderr:
        pytest.skip("the host C++ compiler lacks C++20 <barrier>")
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(so).dsv2t_wavefront_filter
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


# (kind, w, h, blk, chroma shifts, planes, cluster, threads): lanes looped
# over fewer threads than lanes, clusters of 2-8 CTAs, every chroma block
# shape of the five formats, the loads past the prefetch registers (32
# threads for 32-wide tiles)
HOST_CASES = [
    ("intra", 64, 48, 16, (1, 1), 2, None, None),
    ("intra", 64, 48, 16, (1, 1), 1, 4, 32),
    ("luma", 100, 62, 16, (1, 1), 1, 8, None),
    ("luma", 352, 288, 16, (1, 1), 1, None, 32),
    ("luma", 352, 288, 16, (1, 1), 1, 2, None),
    ("chroma", 100, 62, 16, (1, 1), 2, 2, None),
    ("chroma", 128, 96, 32, (0, 0), 1, 2, 32),
    ("chroma", 96, 80, 16, (1, 0), 2, None, None),
    ("chroma", 96, 80, 16, (2, 0), 1, 2, None),
    ("chroma", 96, 80, 16, (2, 2), 1, None, None),
]


@pytest.mark.parametrize("case", HOST_CASES,
                         ids=["%s-%dx%d-b%d-s%d%d-n%d-C%s-T%s" % (
                             c[:4] + c[4] + c[5:]) for c in HOST_CASES])
def test_kernel_source_on_host(host_kernel, case, monkeypatch):
    kind, w, h, blk, shifts, nb, cluster, threads = case
    calls = []
    plain = filters.wavefront_filter_plain

    def rec(kind_, lay, plane, props, scal):
        calls.append((lay, plane.clone(), props, scal))
        return plain(kind_, lay, plane, props, scal)
    monkeypatch.setattr(filters, "wavefront_filter", rec)
    args = golden.filter_case(kind, w, h, blk, shifts, seed=1, nb=nb)
    want = getattr(filters, kind + "_filter_graph")(*args)
    (lay, plane, props, scal), = calls
    plan = filters.wavefront_plan(lay, cluster)
    if threads:
        plan = plan._replace(threads=threads)
    geom = _kernels.wavefront_geom(lay, props.shape[1], plan)
    u8 = plane.to(torch.uint8)
    rc = host_kernel(filters.KINDS.index(kind), u8.data_ptr(),
                     props.data_ptr(), scal.data_ptr(), None, nb,
                     geom.ctypes.data, None)
    assert rc == 0, plan
    got = u8[:, lay.mr:lay.mr + lay.ph, lay.mc:lay.mc + lay.pw]
    assert_same(got, want.reshape(got.shape))
    assert not torch.equal(want, args[{"intra": 4, "luma": 7}.get(kind, 6)])


# (kind, w, h, blk, chroma shifts, planes, windows in the scratch): small
# layouts forced onto the global ring, against the native C filters
GLOBAL_CASES = [
    ("intra", 64, 48, 16, (1, 1), 2, False),
    ("luma", 48, 200, 16, (1, 1), 1, False),
    ("luma", 100, 62, 16, (1, 1), 1, True),
    ("chroma", 64, 160, 32, (0, 0), 2, False),
    ("chroma", 96, 80, 16, (1, 0), 1, True),
]


@pytest.mark.parametrize("case", GLOBAL_CASES,
                         ids=["%s-%dx%d-b%d-s%d%d-n%d-wins%d" % (
                             c[:4] + c[4] + c[5:]) for c in GLOBAL_CASES])
def test_global_ring_on_host(host_kernel, case, monkeypatch):
    """The kernel source with its ring rows in a global scratch (filled
    with garbage: the kernel reads no byte it did not write) equals the
    native C filters, planes batched in one launch."""
    kind, w, h, blk, shifts, nb, scratch_wins = case
    calls = []
    plain = filters.wavefront_filter_plain

    def rec(kind_, lay, plane, props, scal):
        calls.append((lay, plane.clone(), props, scal))
        return plain(kind_, lay, plane, props, scal)
    monkeypatch.setattr(filters, "wavefront_filter", rec)
    args = golden.filter_case(kind, w, h, blk, shifts, seed=3, nb=nb)
    want = golden.filter_native(kind, args)
    getattr(filters, kind + "_filter_graph")(*args)
    (lay, plane, props, scal), = calls
    plan = filters.wavefront_plan(
        lay, ring="global", max_smem=1 if scratch_wins else
        filters.SMEM_OPTIN)
    assert plan.ring == "global" and (plan.smem == 0) == scratch_wins
    geom = _kernels.wavefront_geom(lay, props.shape[1], plan)
    u8 = plane.to(torch.uint8)
    scratch = torch.full((nb * plan.scratch,), 0xCD, dtype=torch.uint8)
    rc = host_kernel(filters.KINDS.index(kind), u8.data_ptr(),
                     props.data_ptr(), scal.data_ptr(), scratch.data_ptr(),
                     nb, geom.ctypes.data, None)
    assert rc == 0, plan
    got = u8[:, lay.mr:lay.mr + lay.ph, lay.mc:lay.mc + lay.pw]
    assert_same(got, want.reshape(got.shape))
    assert not torch.equal(want, args[{"intra": 4, "luma": 7}.get(kind, 6)])
    # a global plan without its scratch is refused
    assert host_kernel(filters.KINDS.index(kind), u8.data_ptr(),
                       props.data_ptr(), scal.data_ptr(), None, nb,
                       geom.ctypes.data, None) != 0
