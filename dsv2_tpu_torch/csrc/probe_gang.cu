// Cost probes for the gang-packed motion-search layout, for Hopper.
//
// Replaces the TPU kernels of tools/probe_gang.py::main (k_block,
// pallas_call :107; k_gang, :162; k_vmem_scalar, :193). Like them, one
// sequential walker (here one warp, one CTA) goes over NB blocks and runs
// EVALS metric evaluations per block, so the time per evaluation is the
// latency of one metric chain in that layout:
// - block (variant 0): a warp per 16x16 window, its lanes over the pixels
//   (8 each); mirrors :84-104: the window at clip(x, 0, WP-16), clip(y, 0,
//   HP-16), b = a rolled down one row, the metric of :70-76 summed, added
//   up over the evaluations. Modes: full; read (adds the window's first
//   pixel); compute (the window is plane[0:16, 0:16] + x, no window read).
// - gang (variant 1): G = 8 windows side by side as one 16x128 tile in
//   shared memory, 4 lanes per window; mirrors :129-159. The metric's
//   horizontal roll wraps across the whole 128-wide tile (column 15 of
//   window g reads column 0 of window g+1, window 7 wraps to window 0), and
//   each evaluation overwrites the window's sum, as the TPU kernel does, so
//   gang and block differ. Modes: full; read (every slot gets window 0's
//   first pixel, :147-149); compute (plane[0:16, 0:16] repeated 8 times,
//   without x: the TPU tool's broadcast_to of a 16x16 tile to 16x128 does
//   not trace, the port reads it as the 8-fold tile).
// - scalar (variant 2): the load at a computed index of :184-191, here a
//   shared-memory load: v = plane[0:8, 0:128], out[i] = v[(sum(v[0]) + i)
//   % 8][0] for i < 128.
// Every evaluation re-reads its windows through volatile loads, so the
// read cost stays in the loop. What bounds it: neither bytes nor
// operations (a few MB and ~0.1 G operations): the one warp's dependent
// load and reduction chain, which is what the probe measures.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW = 16, G = 8, GW = BW * G;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int wsum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the metric of tools/probe_gang.py:70-76 at (r, c) of an h x w tile a,
// with b = a rolled down one row; every roll wraps around the tile
__device__ __forceinline__ int metr_px(const int* t, int r, int c, int h,
                                       int w) {
  auto A = [&](int rr, int cc) { return t[((rr + h) % h) * w + (cc + w) % w]; };
  auto D = [&](int rr, int cc) { return abs(A(rr, cc) - A(rr - 1, cc)); };
  auto XR = [&](int rr, int cc) { return D(rr, cc) + D(rr, cc + 1); };
  const int se = (XR(r, c) + XR(r + 1, c) + 2) >> 2;
  const int a = A(r, c), b = A(r - 1, c);
  const int h2 = (a >> 1) - (b >> 1);
  return se * se + ((a - b) * (a - b) << 1) + h2 * h2;
}

__global__ void probe_block(int mode, const uint8_t* plane, const int* cx,
                            const int* cy, int* out, int nb, int evals,
                            int hp, int wp) {
  __shared__ int w[BW * BW];
  const int lane = threadIdx.x;
  const volatile uint8_t* vp = plane;
  for (int i = 0; i < nb; ++i) {
    const int x = cx[i], y = cy[i];
    const int xx = min(max(x, 0), wp - BW), yy = min(max(y, 0), hp - BW);
    int acc = 0;
    for (int e = 0; e < evals; ++e) {
      __syncwarp();
      for (int p = lane; p < BW * BW; p += 32) {
        const int r = p / BW, c = p % BW;
        w[p] = mode == 2 ? (int)plane[r * wp + c] + x
                         : (int)vp[(yy + r) * wp + xx + c];
      }
      __syncwarp();
      if (mode == 1) {
        acc += w[0];
      } else {
        int s = 0;
        for (int p = lane; p < BW * BW; p += 32)
          s += metr_px(w, p / BW, p % BW, BW, BW);
        acc += wsum(s);
      }
    }
    if (lane == 0) out[i] = acc;
  }
}

__global__ void probe_gang(int mode, const uint8_t* plane, const int* cx,
                           const int* cy, int* out, int nb, int evals,
                           int hp, int wp) {
  __shared__ int w[BW * GW];
  const int lane = threadIdx.x;
  const volatile uint8_t* vp = plane;
  for (int it = 0; it < nb / G; ++it) {
    for (int e = 0; e < evals; ++e) {
      __syncwarp();
      for (int p = lane; p < BW * GW; p += 32) {
        const int r = p / GW, col = p % GW, g = col / BW, c = col % BW;
        if (mode == 2) {
          w[p] = plane[r * wp + c];
        } else {
          const int k = it * G + g;
          const int xx = min(max(cx[k], 0), wp - BW);
          const int yy = min(max(cy[k], 0), hp - BW);
          w[p] = vp[(yy + r) * wp + xx + c];
        }
      }
      __syncwarp();
      if (mode == 1) {
        if (lane < G) out[it * G + lane] = w[0];
      } else {
        // lane l sums columns 4l..4l+3: window l / 4
        int s = 0;
        for (int c = 4 * lane; c < 4 * lane + 4; ++c)
          for (int r = 0; r < BW; ++r) s += metr_px(w, r, c, BW, GW);
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        if ((lane & 3) == 0) out[it * G + lane / 4] = s;
      }
    }
  }
}

__global__ void probe_scalar(const uint8_t* plane, int* out, int wp) {
  __shared__ int v[8 * 128];
  const int lane = threadIdx.x;
  for (int p = lane; p < 8 * 128; p += 32) v[p] = plane[(p / 128) * wp + p % 128];
  __syncwarp();
  int s = 0;
  for (int c = lane; c < 128; c += 32) s += v[c];
  s = wsum(s);
  if (lane == 0)
    for (int i = 0; i < 128; ++i) out[i] = v[((s + i) % 8) * 128];
}

}  // namespace

// One probe on `stream`: variant 0/1/2 (block, gang, scalar), mode 0/1/2
// (full, read, compute; not read by the scalar probe). plane (hp, wp)
// uint8 with hp >= 16 and wp >= 128; cx, cy (nb,) int32; out (nb,) int32
// (128 for the scalar probe). Returns a cudaError_t (0 = ok); allocates
// nothing, does not sync.
extern "C" int dsv2t_probe_gang(int variant, int mode, const uint8_t* plane,
                                const int* cx, const int* cy, int* out, int nb,
                                int evals, int hp, int wp, void* stream) {
  if (hp < BW || wp < GW || nb < 0 || evals < 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      probe_block<<<1, 32, 0, st>>>(mode, plane, cx, cy, out, nb, evals, hp, wp);
      break;
    case 1:
      probe_gang<<<1, 32, 0, st>>>(mode, plane, cx, cy, out, nb, evals, hp, wp);
      break;
    case 2:
      probe_scalar<<<1, 32, 0, st>>>(plane, out, wp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
