// Cost probes for the gang-packed motion-search layout, for Hopper.
//
// Replaces the TPU kernels of tools/probe_gang.py::main (:33): k_block
// (pallas_call :107), k_gang (:162) and k_vmem_scalar (:193). They time
// the metric chain of the motion search in two layouts over NB blocks of
// EVALS evaluations each:
// - block (variant 0): one 16x16 window per block, as :84-104: the window
//   at clip(x, 0, WP-16), clip(y, 0, HP-16), b = a rolled down one row,
//   the metric of :70-76 summed, added up over the evaluations. Modes:
//   full; read (adds the window's first pixel); compute (the window is
//   plane[0:16, 0:16] + x, no window read).
// - gang (variant 1): G = 8 windows side by side as one 16x128 tile, as
//   :129-159. The metric's horizontal roll wraps across the whole 128-wide
//   tile (column 15 of window g reads column 0 of window g+1, window 7
//   wraps to window 0), and each evaluation overwrites the windows' sums,
//   so gang and block differ. Modes: full; read (every slot gets window
//   0's first pixel, :147-149); compute (plane[0:16, 0:16] repeated 8
//   times, without x: the TPU tool's broadcast_to of a 16x16 tile to
//   16x128 does not trace, the port reads it as the 8-fold tile).
// - scalar (variant 2): the load at a computed index of :184-191: v =
//   plane[0:8, 0:128], out[i] = v[(sum(v[0]) + i) % 8][0] for i < 128.
//
// What bounds it on an H100: neither bytes (the 160 KB plane and the
// coordinates, 0.00005 ms) nor operations (~20 per pixel of every
// evaluation, 0.00086 ms at NB = 704). The blocks, and the gangs, depend
// on nothing else, so spread over the card the time is the launch and the
// per-SM tail: one warp's EVALS evaluations of its window, each a chain of
// shared-memory loads, shuffles and a reduction. The TPU tool walks the
// blocks in order on its one core (grid=(1,)); the same walk on one warp
// of one CTA uses 1/132 of the SMs and one warp of 64 on its SM.
//
// What the design does about it:
// - Spread: a warp per window (block) or per gang ("unit"); CTA k of
//   `ctas` takes the units [k*units/ctas, (k+1)*units/ctas) and its warps
//   take them in turn (a warp with none does nothing; the gang slots past
//   the last whole gang are never touched and stay 0). The wrapper
//   computes the shape (dsv2_tpu_torch/tools/probe_gang.launch_shape): by
//   default a warp per unit over every SM; walkers=1 is the TPU tool's
//   sequential walk, one warp of one CTA over every block in order, whose
//   time per evaluation is the latency of one chain.
// - Shared memory plays the part of VMEM: a warp stages its unit's
//   windows with cp.async (csrc/cp_async.cuh; 16 rows of the two aligned
//   16-byte chunks that hold each window's 16 columns), the next unit's
//   while it evaluates the current one. Every evaluation re-reads its
//   window from there at the window's byte offset (the counterpart of the
//   TPU's overfetch and roll) through a volatile pointer, so that no
//   evaluation is hoisted or folded into another; each gang evaluation
//   stores its sums (as the TPU kernel does), so none is dead. Compute
//   mode stages plane[0:16, 0:16] once.
// - The metric chain in registers: block, lane l holds column l % 16 of
//   rows 8*(l/16)..+7; gang, lane l holds columns 4l..4l+3 of the 16x128
//   tile, all 16 rows. d = |a - b| once per pixel (b: the row above,
//   wrapping); the one-column roll is a shuffle from the next lane (gang:
//   lane 31 reads lane 0, the TPU roll's wrap across the tile); the row
//   rolls stay in registers (block: across the half-warp, a shuffle); the
//   quad average is the search's uavg4 (csrc/metr.cuh); the sums reduce
//   with shuffles.
// - The scalar probe stays on one warp of one CTA: its 128 loads at
//   computed indices, one lane's after another, are what it measures.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "metr.cuh"

namespace {

constexpr int BW = 16, G = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a staged window: 16 rows of 32 bytes (the two aligned 16-byte chunks
// around its columns), rows 8-15 one row further on so that the two
// half-warps of the block probe read other banks
constexpr int kRow = 32, kWin = 17 * kRow;
constexpr int kMaxWarps[2] = {32, 4};  // warps per CTA, block and gang
constexpr int kSink = 32;              // a warp's gang sums, 8 ints

__device__ __forceinline__ int row_at(int r) { return r * kRow + (r & 8) * 4; }
__device__ __forceinline__ int clip(int v, int hi) { return min(max(v, 0), hi); }

// the window at (xx, yy) into dst: lane l copies row l/2's chunk l%2; a
// chunk past the plane's end (right of the last row's window) is zeroed,
// and no read reaches it
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* plane,
                                      int xx, int yy, int hp, int wp,
                                      int lane) {
  const int r = lane >> 1, h = lane & 1;
  const long long off = (long long)(yy + r) * wp + (xx & ~15) + 16 * h;
  const bool in = off + 16 <= (long long)hp * wp;
  cpa::copy16(dst + row_at(r) + 16 * h, in ? plane + off : plane,
              in ? 16 : 0);
}

// the windows of unit u (corner: plane[0:16, 0:16] once, in slot 0)
template <int V>
__device__ __forceinline__ void stage_unit(uint8_t* dst, const uint8_t* plane,
                                           const int* cx, const int* cy,
                                           int u, bool corner, int hp,
                                           int wp, int lane) {
  for (int g = 0; g < (V && !corner ? G : 1); ++g) {
    const int k = V ? u * G + g : u;
    stage(dst + g * kWin, plane, corner ? 0 : clip(cx[k], wp - BW),
          corner ? 0 : clip(cy[k], hp - BW), hp, wp, lane);
  }
}

// 4 bytes at byte offset o of a staged window's words
__device__ __forceinline__ uint32_t word_at(const volatile uint32_t* w,
                                            int o) {
  return __funnelshift_r(w[o >> 2], w[(o >> 2) + 1], (o & 3) * 8);
}

// the block metric of a 16x16 window, summed over the warp: lane holds
// a[k] = pixel (8*(lane/16) + k, lane % 16)
__device__ __forceinline__ int metr_block(const int (&a)[8], int lane) {
  const int up = __shfl_xor_sync(FULL, a[7], 16);  // the row above row 0
  const int right = (lane & 16) | ((lane + 1) & 15);
  int d[9], dn[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = iabs(a[k] - (k ? a[k - 1] : up));
#pragma unroll
  for (int k = 0; k < 8; ++k) dn[k] = __shfl_sync(FULL, d[k], right);
  d[8] = __shfl_xor_sync(FULL, d[0], 16);  // the row below row 7
  dn[8] = __shfl_xor_sync(FULL, dn[0], 16);
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = k ? a[k - 1] : up;
    const int se = uavg4(d[k], dn[k], d[k + 1], dn[k + 1]);
    const int h2 = (a[k] >> 1) - (b >> 1);
    s += se * se + ((a[k] - b) * (a[k] - b) << 1) + h2 * h2;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// the gang metric of a 16x128 tile, summed over each window's 4 lanes:
// lane holds a[r][j] = pixel (r, 4*lane + j)
__device__ __forceinline__ int metr_gang(const int (&a)[BW][4], int lane) {
  const int right = (lane + 1) & 31;
  int d[BW][5];
#pragma unroll
  for (int r = 0; r < BW; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[r][j] = iabs(a[r][j] - a[(r + 15) & 15][j]);
#pragma unroll
  for (int r = 0; r < BW; ++r) d[r][4] = __shfl_sync(FULL, d[r][0], right);
  int s = 0;
#pragma unroll
  for (int r = 0; r < BW; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r1 = (r + 1) & 15, a0 = a[r][j], b = a[(r + 15) & 15][j];
      const int se = uavg4(d[r][j], d[r][j + 1], d[r1][j], d[r1][j + 1]);
      const int h2 = (a0 >> 1) - (b >> 1);
      s += se * se + ((a0 - b) * (a0 - b) << 1) + h2 * h2;
    }
  s += __shfl_xor_sync(FULL, s, 1);
  s += __shfl_xor_sync(FULL, s, 2);
  return s;
}

template <int V>
__global__ void probe_tile(int mode, const uint8_t* plane, const int* cx,
                           const int* cy, int* out, int units, int evals,
                           int hp, int wp) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kUnit = V ? G * kWin : kWin, kWarp = 2 * kUnit + kSink;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int hi = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  int u = (int)((long long)blockIdx.x * units / gridDim.x) + warp;
  if (u >= hi) return;
  uint8_t* buf = smem + warp * kWarp;
  volatile int* sink = (volatile int*)(buf + 2 * kUnit);
  const bool corner = mode == 2;
  stage_unit<V>(buf, plane, cx, cy, u, corner, hp, wp, lane);
  cpa::commit();
  for (int j = 0; u < hi; u += warps, ++j) {
    if (!corner && u + warps < hi)
      stage_unit<V>(buf + ((j + 1) & 1) * kUnit, plane, cx, cy, u + warps,
                    false, hp, wp, lane);
    cpa::commit();
    cpa::wait1();
    __syncwarp();
    const uint8_t* win = buf + (corner ? 0 : (j & 1) * kUnit);
    if (V == 0) {
      const int x = corner ? cx[u] : 0;
      const int s = corner ? 0 : clip(cx[u], wp - BW) & 15;
      const volatile uint8_t* p = win + s + (lane & 15);
      const int r0 = (lane >> 4) * 8;
      unsigned acc = 0;
      for (int e = 0; e < evals; ++e) {
        int a[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          a[k] = (int)((unsigned)p[row_at(r0 + k)] + (unsigned)x);
        acc += mode == 1 ? (unsigned)a[0] : (unsigned)metr_block(a, lane);
      }
      if (lane == 0) out[u] = (int)acc;
    } else {
      const int g = lane >> 2, q = lane & 3;
      const int s = corner ? 0 : clip(cx[u * G + g], wp - BW) & 15;
      const volatile uint32_t* w =
          (const volatile uint32_t*)(win + (corner ? 0 : g * kWin));
      int res = 0;
      for (int e = 0; e < evals; ++e) {
        int a[BW][4];
#pragma unroll
        for (int r = 0; r < BW; ++r) {
          const uint32_t v = word_at(w, row_at(r) + s + 4 * q);
#pragma unroll
          for (int k = 0; k < 4; ++k) a[r][k] = (v >> (8 * k)) & 255;
        }
        res = mode == 1 ? __shfl_sync(FULL, a[0][0], 0) : metr_gang(a, lane);
        if (q == 0) sink[g] = res;
      }
      if (q == 0) out[u * G + g] = res;
    }
    __syncwarp();  // the buffer read here is restaged next iteration
  }
}

__global__ void probe_scalar(const uint8_t* plane, int* out, int wp) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* v = (int*)smem;
  const int lane = threadIdx.x;
  for (int p = lane; p < 8 * 128; p += 32) v[p] = plane[(p / 128) * wp + p % 128];
  __syncwarp();
  int s = 0;
  for (int c = lane; c < 128; c += 32) s += v[c];
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0)
    for (int i = 0; i < 128; ++i) out[i] = v[((s + i) % 8) * 128];
}

}  // namespace

// One probe on `stream`: variant 0/1/2 (block, gang, scalar), mode 0/1/2
// (full, read, compute; not read by the scalar probe). plane (hp, wp)
// uint8, 16-byte aligned, with hp >= 16, wp >= 128 and wp a multiple of
// 16; cx, cy (nb,) int32; out (nb,) int32, zeroed (128 for the scalar
// probe). The block and gang probes run on `ctas` CTAs of `warps` warps
// (at most 32, gang 4; the wrapper's launch_shape), none when there is no
// block (gang: no whole gang). Returns a cudaError_t (0 = ok); allocates
// nothing, does not sync.
extern "C" int dsv2t_probe_gang(int variant, int mode, const uint8_t* plane,
                                const int* cx, const int* cy, int* out, int nb,
                                int evals, int hp, int wp, int ctas, int warps,
                                void* stream) {
  if (hp < BW || wp < 128 || wp % 16 || ((uintptr_t)plane & 15) || nb < 0 ||
      evals < 0 || mode < 0 || mode > 2 || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 2) {
    probe_scalar<<<1, 32, 8 * 128 * sizeof(int), st>>>(plane, out, wp);
    return (int)cudaGetLastError();
  }
  const int units = variant ? nb / G : nb;
  if (units == 0 && ctas == 0) return (int)cudaSuccess;
  if (ctas < 1 || ctas > units || warps < 1 || warps > kMaxWarps[variant])
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * (2 * (variant ? G : 1) * kWin + kSink);
  if (variant == 0)
    probe_tile<0><<<ctas, 32 * warps, smem, st>>>(mode, plane, cx, cy, out,
                                                  units, evals, hp, wp);
  else
    probe_tile<1><<<ctas, 32 * warps, smem, st>>>(mode, plane, cx, cy, out,
                                                  units, evals, hp, wp);
  return (int)cudaGetLastError();
}
