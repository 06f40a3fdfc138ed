// The rice vk adaptation chain of the on-device entropy scan, for Hopper.
//
// Replaces the TPU kernel dsv2_tpu/ops/scan_pl.py::_vk_vec_batched
// (kernel body at :148, reached through _vk_call :204 from make_scan_blob
// :411). Semantics (plain version: dsv2_tpu_torch/ops/scan_pl.py
// vk_chain_plain): B independent chains over a time-major thr (npad, B)
// int32. Chain b walks rows [s0_b, nnz_b) in order, stores the PRE-update
// vk, then sets vk <- vk+1 if vk < thr[i][b] else max(vk-1, 0). Every row
// of vkpre is defined: 0 below s0, the final vk at and above nnz (the TPU
// kernel leaves rows past its last live chunk unwritten).
//
// What bounds it: one sequential dependence per chain (a compare, an add
// and a max), not bytes or FLOPs; at FHD luma a chain is ~2.1M rows long.
// Design: one thread per chain, all chains of a launch in one warp (B <=
// 32 per block), so the warp walks the union of its chains' live ranges in
// lockstep and each row load thr[i*B .. i*B+B) is one coalesced
// transaction; per-lane live masks let shorter chains coast. Rows are
// walked in unrolled groups whose loads are all issued before the group's
// dependent chain, and the next group's loads are issued before the
// current group is walked, so load latency overlaps the chain. nnz and s0
// are read from device memory: the host never reads max(nnz). A second,
// fully parallel kernel fills the rows outside each chain's range. If the
// card shows this chain hot, chunked look-ahead (a parallel prefix over
// per-chunk transition tables) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 16;

__device__ __forceinline__ int vk_step(int vk, int t) {
  return vk < t ? vk + 1 : max(vk - 1, 0);
}

__global__ void __launch_bounds__(kWarp)
vk_chain_kernel(const int* __restrict__ thr, const int* __restrict__ s0,
                const int* __restrict__ nnz, int* __restrict__ vkpre,
                int* __restrict__ vkend, int npad, int nchain) {
  const int b = blockIdx.x * kWarp + threadIdx.x;
  const bool on = b < nchain;
  const int lo = on ? min(max(s0[b], 0), npad) : npad;
  const int hi = on ? max(min(nnz[b], npad), lo) : 0;
  const int wlo = __reduce_min_sync(0xffffffffu, lo);
  const int whi = __reduce_max_sync(0xffffffffu, hi);
  const size_t ld = (size_t)nchain;
  const int* col = thr + b;
  int* out = vkpre + b;
  int vk = 0;
  int i = wlo;
  if (i + kUnroll <= whi) {
    int cur[kUnroll];
    int nxt[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      cur[j] = on ? __ldg(col + (size_t)(i + j) * ld) : 0;
    for (; i + kUnroll <= whi; i += kUnroll) {
      const bool more = i + 2 * kUnroll <= whi;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        nxt[j] = (on && more) ? __ldg(col + (size_t)(i + kUnroll + j) * ld)
                              : 0;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int r = i + j;
        if (on) out[(size_t)r * ld] = vk;
        const int nv = vk_step(vk, cur[j]);
        vk = (r >= lo && r < hi) ? nv : vk;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) cur[j] = nxt[j];
    }
  }
  for (; i < whi; ++i) {
    const int t = on ? __ldg(col + (size_t)i * ld) : 0;
    if (on) out[(size_t)i * ld] = vk;
    const int nv = vk_step(vk, t);
    vk = (i >= lo && i < hi) ? nv : vk;
  }
  if (on) vkend[b] = vk;
}

// Rows outside [s0_b, nnz_b): 0 below, the chain's final vk at and above.
// (Rows inside the warp's walked range were already written with the same
// values; writing them again is harmless.)
__global__ void vk_fill_kernel(const int* __restrict__ s0,
                               const int* __restrict__ nnz,
                               const int* __restrict__ vkend,
                               int* __restrict__ vkpre, int npad,
                               int nchain) {
  const size_t n = (size_t)npad * nchain;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(e / nchain);
    const int b = (int)(e % nchain);
    const int lo = min(max(s0[b], 0), npad);
    const int hi = max(min(nnz[b], npad), lo);
    if (i < lo)
      vkpre[e] = 0;
    else if (i >= hi)
      vkpre[e] = vkend[b];
  }
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// vkend is (nchain,) int32 scratch. Allocates nothing, does not sync.
extern "C" int dsv2t_vk_chain(const int* thr, const int* s0, const int* nnz,
                              int* vkpre, int* vkend, int npad, int nchain,
                              void* stream) {
  if (npad <= 0 || nchain <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nwarps = (nchain + kWarp - 1) / kWarp;
  vk_chain_kernel<<<nwarps, kWarp, 0, st>>>(thr, s0, nnz, vkpre, vkend,
                                            npad, nchain);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)npad * nchain;
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  vk_fill_kernel<<<(unsigned)blocks, threads, 0, st>>>(s0, nnz, vkend, vkpre,
                                                       npad, nchain);
  return (int)cudaGetLastError();
}
