// The in-loop filter wavefront of the decoder and the encoder's
// reconstruction loop, for Hopper.
//
// Replaces the TPU kernels dsv2_tpu/ops/filters_pl.py::_run_wavefront_pl
// (:273; the plane whole in VMEM) and ::_hbm_call (:368; the plane in HBM,
// each diagonal's window DMA'd, batched over a grid (B, nd)). The
// VMEM/HBM split has no counterpart here: one launch runs B planes.
// Semantics (plain version: dsv2_tpu_torch/ops/filters.py
// wavefront_filter_plain): the reference's raster scan of 4x4 tiles (intra
// dering, inter luma cleanup + de-gradient sharpen) or of whole blocks
// (inter chroma), reproduced as a wavefront over the anti-diagonals
// d = i + 2*j of the tile grid. A tile reads its (th+8, tw+8) window around
// the tile; same-diagonal tiles write disjoint pixels but a tile's window
// can overlap pixels its same-diagonal neighbour writes, so every window of
// a diagonal is read before any delta of that diagonal is added back.
//
// Layout: plane (B, HP, WP) int32, unskewed, the visible plane at (mr, mc)
// inside zero margins (reads past the visible plane see 0, and writes there
// persist, as in the twin). props (B, NP, nty, ntx) int32 per tile, scal
// (B, 8) int32 per plane.
//
// What bounds it on an H100: by bytes an FHD luma plane read once and
// written once as int32 is ~17 MB, ~5 us at 3.35 TB/s, and the arithmetic
// is a few thousand integer operations per tile. In practice the chain of
// nd dependent diagonals (1,015 at FHD luma) sets the time: each diagonal
// is a window load from L2, the step, two barriers and the adds back.
// Design: one CTA per plane, one thread per lane (tile) of a diagonal, a
// loop over the diagonals inside the CTA in place of the TPU's sequential
// grid; each thread keeps its window in shared memory (L x wh x ww int32,
// 139 KB at FHD luma, opted in above 48 KB). Plane loads bypass L1
// (__ldcg) so a diagonal always sees the previous diagonal's adds. Nothing
// more yet: keeping a band of the plane in shared memory, or several
// planes per SM, is the next step if the card shows it hot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// flag bits, as dsv2_tpu_torch/core/constants.py defines them (a CPU test
// holds these lines against it)
#define DSV2T_STABLE_BIT 0
#define DSV2T_MAINTAIN_BIT 1
#define DSV2T_RINGING_BIT 3
#define DSV2T_MV_BIT_INTRA 0
#define DSV2T_MV_BIT_EPRM 1
#define DSV2T_MV_BIT_SKIP 3
#define DSV2T_MASK_ALL_INTRA 15

constexpr int kIntra = 0, kLuma = 1, kChroma = 2;
constexpr int kMaxThreads = 512;

struct Geom {
  int pw, ph, tw, th, ntx, nty, L, nd, mr, mc, HP, WP, wh, ww, NP, wstride;
};

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int lpf6(int e0, int i0, int e1, int i1) {
  return (5 * (e0 + i0) + 3 * (e1 + i1) + 8) >> 4;
}

__device__ __forceinline__ bool flat6(int e2, int e1, int e0, int i0, int i1,
                                      int i2, int avg, int t) {
  return iabs(e0 - avg) < t && iabs(i0 - avg) < t && iabs(e1 - avg) < t &&
         iabs(i1 - avg) < t && iabs(e2 - avg) < t && iabs(i2 - avg) < t;
}

// The 11 taps at p[-3*s], ..., p[7*s] around a boundary at p[0]: the
// boundary writes taps -2..1, the interior boundary at p[4*s] taps 3..6
// (ref: bmc.c:51-191). All taps are read before any write.
__device__ __forceinline__ void edge_pair(int* p, int s, int thE, int thM,
                                          bool in_edge) {
  int c[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) c[k] = p[(k - 3) * s];
  const int e2 = c[0], e1 = c[1], e0 = c[2], i0 = c[3], i1 = c[4], i2 = c[5];
  const int avg = lpf6(e0, i0, e1, i1);
  if (flat6(e2, e1, e0, i0, i1, i2, avg, thE)) {
    const int a5 = avg * 5;
    p[-2 * s] = (3 * (avg + e1) + 2 * e2 + 4) >> 3;
    p[-1 * s] = (a5 + 2 * e1 + e2 + 4) >> 3;
    p[0] = avg;
    p[1 * s] = (a5 + 2 * i1 + i2 + 4) >> 3;
  }
  const int i2b = c[5], i1b = c[6], i0b = c[7], e0b = c[8], e1b = c[9],
            e2b = c[10];
  const int avgb = lpf6(e0b, i0b, e1b, i1b);
  if (in_edge && flat6(e2b, e1b, e0b, i0b, i1b, i2b, avgb, thM)) {
    const int a5b = avgb * 5;
    p[3 * s] = (a5b + 2 * i1b + i2b + 4) >> 3;
    p[4 * s] = avgb;
    p[5 * s] = (a5b + 2 * e1b + e2b + 4) >> 3;
    p[6 * s] = (3 * (avgb + e1b) + 2 * e2b + 4) >> 3;
  }
}

// Vertical boundary at window col co, rows ro..ro+3 (ref: bmc.c:51-119).
__device__ void hfilt(int* W, int ww, int ro, int co, bool edge, int thE,
                      int thM, bool guard, bool in_edge) {
  if (!(guard && thM > 0 && !(edge && thE <= 0))) return;
  const int te = edge ? thE : thM;
  for (int r = 0; r < 4; ++r) edge_pair(W + (ro + r) * ww + co, 1, te, thM,
                                        in_edge);
}

// Horizontal boundary at window row ro, cols co..co+3 (ref: bmc.c:121-191).
__device__ void vfilt(int* W, int ww, int ro, int co, bool edge, int thE,
                      int thM, bool guard, bool in_edge) {
  if (!(guard && thM > 0 && !(edge && thE <= 0))) return;
  const int te = edge ? thE : thM;
  for (int c = 0; c < 4; ++c) edge_pair(W + ro * ww + co + c, ww, te, thM,
                                        in_edge);
}

struct Quads {
  int d0, d1, d2, d3;
};

__device__ __forceinline__ Quads quads(const int* t, int ww) {
#define T(r, c) t[(r) * ww + (c)]
  Quads q;
  q.d0 = (T(0, 0) + T(0, 1) + T(1, 0) + T(1, 1) + 2) >> 2;
  q.d1 = (T(0, 2) + T(0, 3) + T(1, 2) + T(1, 3) + 2) >> 2;
  q.d2 = (T(2, 0) + T(2, 1) + T(3, 0) + T(3, 1) + 2) >> 2;
  q.d3 = (T(2, 2) + T(2, 3) + T(3, 2) + T(3, 3) + 2) >> 2;
#undef T
  return q;
}

// 4x4 haar + downsampled energy of the tile at t (ref: bmc.c:224-270).
__device__ void tile_energy(const int* t, int ww, int& sh, int& sv, int& slh,
                            int& slv) {
  sh = sv = 0;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int x0 = t[(2 * a) * ww + 2 * b];
      const int x1 = t[(2 * a) * ww + 2 * b + 1];
      const int x2 = t[(2 * a + 1) * ww + 2 * b];
      const int x3 = t[(2 * a + 1) * ww + 2 * b + 1];
      const int hh = iabs(x0 - x1 - x2 + x3) >> 1;
      sh += iabs(x0 - x1 + x2 - x3) + hh;
      sv += iabs(x0 + x1 - x2 - x3) + hh;
    }
  const Quads q = quads(t, ww);
  const int hhl = iabs(q.d0 - q.d1 - q.d2 + q.d3) >> 1;
  slh = iabs(q.d0 - q.d1 + q.d2 - q.d3) + hhl;
  slv = iabs(q.d0 + q.d1 - q.d2 - q.d3) + hhl;
}

// Downsampled smoothing factor (ref: bmc.c:193-222).
__device__ int dsfactor(const int* t, int ww) {
  const Quads q = quads(t, ww);
  const int sh = iabs((q.d0 + q.d1) - (q.d3 + q.d2));
  const int sv = iabs((q.d2 + q.d1) - (q.d3 + q.d0));
  if (max(sh, sv) < 8) return 0;
  const int d2b = 255 - q.d2, d3b = 255 - q.d3;
  const int sh2 = iabs(q.d0 - q.d1 + d2b - d3b);
  const int sv2 = iabs(q.d0 + q.d1 - d2b - d3b) >> 2;
  return sh2 > sv2 ? (3 * sh2 + sv2 + 2) >> 2 : (3 * sv2 + sh2 + 2) >> 2;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Histogram de-gradient sharpener on the 4x4 tile (ref: bmc.c:272-337).
// lo/hi are the first/last occupied of 16 bins (0/15 when none is, as the
// twin's argmax gives).
__device__ void degrad(int* t, int ww) {
  int hist[16], sums[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) hist[b] = sums[b] = 0;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      const int v = t[r * ww + c];
      const int b = v >> 4;
      if (b >= 0 && b < 16) {
        hist[b] += 1;
        sums[b] += v;
      }
    }
  int lo = -1, hi = -1;
  for (int b = 0; b < 16; ++b)
    if (hist[b] > 0) {
      if (lo < 0) lo = b;
      hi = b;
    }
  if (lo < 0) lo = 0;
  if (hi < 0) hi = 15;
  if (!(lo < hi)) return;
  const int hl = hist[lo], hh = hist[hi];
  const int alo = max(floordiv(sums[lo], max(hl, 1)), 1);
  const int ahi = max(floordiv(sums[hi], max(hh, 1)), 1);
  const int mid = (alo + ahi + 1) >> 1;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      const int v = t[r * ww + c];
      // C division truncates, as the twin's divt does
      if (v < mid)
        t[r * ww + c] = v + (hl * (alo - v)) / 16;
      else if (v > mid)
        t[r * ww + c] = v + (hh * (ahi - v)) / 16;
    }
}

__device__ __forceinline__ int curve_tex(int tt) {
  return tt < 8 ? (8 - tt) * 8 : (tt > 192 ? 0 : tt - 7);
}

// ref: bmc.c:390-457. sc = (fq, fthresh * do_filter).
__device__ void intra_step(int* W, const Geom& g, const int* pr, int i, int j,
                           const int* sc) {
  const int ww = g.ww;
  const int fq = sc[0], fth = sc[1];
  const int flags = pr[0];
  int* t = W + 4 * ww + 4;
  int sh, sv, slh, slv;
  tile_energy(t, ww, sh, sv, slh, slv);
  const int mx = max(sh, sv);
  const bool me = (flags & (1 << DSV2T_RINGING_BIT)) == 0 && mx < 256 &&
                  mx > 8;
  if (!me) return;  // every threshold below is 0 then
  const bool ms =
      (flags & ((1 << DSV2T_MAINTAIN_BIT) | (1 << DSV2T_STABLE_BIT))) != 0;
  int ttd = dsfactor(t, ww);
  if (flags & (1 << DSV2T_STABLE_BIT)) ttd = (ttd * 5) >> 2;
  int tt = ms ? ttd : 8;
  tt = (tt * 2) / 3;
  tt = min(max((tt * fq) >> 12, 0), fth);
  const bool mh = i >= 1, mv = j >= 1;
  const bool ieh = i * 4 < g.pw - 8, iev = j * 4 < g.ph - 8;
  hfilt(W, ww, 4, 4, false, tt, tt, mh, ieh);
  vfilt(W, ww, 4, 4, false, tt, tt, mv, iev);
  int tt2 = sh > sv ? 3 * sh + sv : 3 * sv + sh;
  tt2 = curve_tex(tt2);
  tt2 = 16 + ((tt2 + 2) >> 2);
  tt2 = min(max((tt2 * fq) >> 12, 0), fth);
  hfilt(W, ww, 4, 4, false, tt2, tt2, mh, ieh);
  vfilt(W, ww, 4, 4, false, tt2, tt2, mv, iev);
}

// ref: bmc.c:459-602. sc = (fq, fthresh, do_filter, tmc, inter_sharpen);
// pr = (mvx, mvy, flags, submask, ndx, ndy, eh, ev, ehs, evs).
__device__ void luma_step(int* W, const Geom& g, const int* pr, int i, int j,
                          const int* sc) {
  const int ww = g.ww;
  const int fq = sc[0], fth = sc[1];
  const bool dof = sc[2] != 0, sharpen = sc[4] * sc[3] != 0;
  const int thH = clampi((64 * fq) >> 12, 2, 32);
  const int thL = clampi((32 * fq) >> 12, 2, 32);
  const int bmvx = pr[0], bmvy = pr[1], fl = pr[2], sub = pr[3];
  const int ndx = pr[4], ndy = pr[5];
  const bool eh = pr[6] != 0, ev = pr[7] != 0, ehs = pr[8] != 0,
             evs = pr[9] != 0;
  if ((fl >> DSV2T_MV_BIT_SKIP) & 1) return;
  const bool intra = (fl >> DSV2T_MV_BIT_INTRA) & 1;
  const bool eprm = (fl >> DSV2T_MV_BIT_EPRM) & 1;
  const int amx = iabs(bmvx), amy = iabs(bmvy);
  const bool mh = i >= 1, mv = j >= 1;
  const bool ieh = i * 4 < g.pw - 8, iev = j * 4 < g.ph - 8;
  if (intra) {
    // intra blocks, filtered regardless of do_filter (ref: bmc.c:529-545)
    const bool subne = sub != DSV2T_MASK_ALL_INTRA;
    hfilt(W, ww, 4, 4, eh || (subne && ehs), thH, thL, mh, ieh);
    vfilt(W, ww, 4, 4, ev || (subne && evs), thH, thL, mv, iev);
    return;
  }
  int* t = W + 4 * ww + 4;
  if (dof && (ndx != 0 || ndy != 0)) {
    // inter blocks with neighbour-MV divergence (ref: bmc.c:547-594)
    int sh, sv, slh, slv;
    tile_energy(t, ww, sh, sv, slh, slv);
    const int tndc = (ndx + ndy + 1) >> 1;
    const bool cdir = sh < 2 * sv && sv < 2 * sh;
    const int ndx_e = (cdir && ndx < amx) ? ndx >> 1 : ndx;
    const int ndy_e = (cdir && ndy < amy) ? ndy >> 1 : ndy;
    const int shl = slh > 128 ? 0 : 128 - slh;
    const int svl = slv > 128 ? 0 : 128 - slv;
    const int ix = min(amx, 32), iy = min(amy, 32);
    int ttA = ((sh * (32 - iy) + shl * iy) + 16) >> 5;
    ttA += ((sv * (32 - ix) + svl * ix) + 16) >> 5;
    ttA = (ttA + 1) >> 1;
    if (ndx_e < amy && ndy_e < amx) ttA = 0;
    int tt = cdir ? ttA : (sh + sv + 1) >> 1;
    tt = (tt * tndc + 4) >> 3;
    tt = (min(tt, fth) * fq) >> 12;
    const int addx = (min(ndy_e, fth) * fq) >> 12;
    const int addy = (min(ndx_e, fth) * fq) >> 12;
    const bool bv = sh > 2 * sv || amy > 2 * amx;
    const bool bh = (sv > 2 * sh || amx > 2 * amy) && !bv;
    const bool mboth = !bv && !bh;
    hfilt(W, ww, 4, 4, eh || eprm, tt + addx, tt, (bh || mboth) && mh, ieh);
    vfilt(W, ww, 4, 4, ev || eprm, tt + addy, tt, (bv || mboth) && mv, iev);
  }
  // qpel diagonal sharpen (ref: bmc.c:595-601)
  const bool qdiag = (bmvx & 3) != 0 && (bmvy & 3) != 0 &&
                     ((bmvx | bmvy) & 1) != 0;
  if (sharpen && qdiag && amx < 8 && amy < 8) degrad(t, ww);
}

// ref: bmc.c:604-659. sc = (q,); pr = (mvx, mvy, flags, ndx, ndy).
__device__ void chroma_step(int* W, const Geom& g, const int* pr, int i,
                            int j, const int* sc) {
  const int ww = g.ww, bw = g.tw, bh = g.th, pw = g.pw, ph = g.ph;
  const int q = sc[0];
  const int bmvx = pr[0], bmvy = pr[1], fl = pr[2], ndx = pr[3],
            ndy = pr[4];
  if ((fl >> DSV2T_MV_BIT_SKIP) & 1) return;
  const bool intra = (fl >> DSV2T_MV_BIT_INTRA) & 1;
  const int amx = iabs(bmvx), amy = iabs(bmvy);
  const bool cz = ndx < amy && ndy < amx;
  int tx = cz ? 0 : (min(ndy, 64) * q) >> 12;
  int ty = cz ? 0 : (min(ndx, 64) * q) >> 12;
  if (intra) tx = ty = clampi((64 * q) >> 12, 2, 32);
  const int x0 = i * bw, y0 = j * bh;
  const bool ieh = x0 < pw - 8, iev = y0 < ph - 8;
  const bool ghx = x0 >= 4 && x0 <= pw - 4;
  const bool gvy = y0 >= 4 && y0 <= ph - 4;
  for (int z = 0; z < bh; z += 4)
    hfilt(W, ww, 4 + z, 4, false, tx, tx, ghx && y0 + z + 4 < ph, ieh);
  for (int z = 0; z < bw; z += 4)
    vfilt(W, ww, 4, 4 + z, false, ty, ty, gvy && x0 + z + 4 < pw, iev);
}

template <int KIND>
__global__ void __launch_bounds__(kMaxThreads)
wavefront_kernel(int* __restrict__ planes, const int* __restrict__ props,
                 const int* __restrict__ scal, Geom g) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  int* P = planes + (size_t)b * g.HP * g.WP;
  const size_t ptile = (size_t)g.nty * g.ntx;
  const int* pb = props + (size_t)b * g.NP * ptile;
  int sc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sc[k] = scal[b * 8 + k];
  const int lane = threadIdx.x;
  int* W = smem + (size_t)lane * g.wstride;
  for (int d = 0; d < g.nd; ++d) {
    const int j0 = max(0, (d - (g.ntx - 1) + 1) >> 1);
    const int j = j0 + lane, i = d - 2 * j;
    const bool valid = lane < g.L && j < g.nty && i >= 0;
    int* src = P;
    if (valid) {
      // phase 1: this lane's window (the plane holds diagonal d-1's result)
      src += (size_t)(g.mr - 4 + j * g.th) * g.WP + (g.mc - 4 + i * g.tw);
      for (int r = 0; r < g.wh; ++r)
        for (int c = 0; c < g.ww; ++c)
          W[r * g.ww + c] = __ldcg(src + (size_t)r * g.WP + c);
      int pr[10];
      for (int k = 0; k < g.NP; ++k)
        pr[k] = pb[k * ptile + (size_t)j * g.ntx + i];
      if (KIND == kIntra) intra_step(W, g, pr, i, j, sc);
      if (KIND == kLuma) luma_step(W, g, pr, i, j, sc);
      if (KIND == kChroma) chroma_step(W, g, pr, i, j, sc);
      // deltas against the plane, which no lane has written this diagonal
      for (int r = 0; r < g.wh; ++r)
        for (int c = 0; c < g.ww; ++c)
          W[r * g.ww + c] -= __ldcg(src + (size_t)r * g.WP + c);
    }
    __syncthreads();  // every window of diagonal d is read
    if (valid) {
      // phase 2: add back only what changed; an unchanged halo pixel may be
      // a same-diagonal neighbour's write
      for (int r = 0; r < g.wh; ++r)
        for (int c = 0; c < g.ww; ++c) {
          const int dv = W[r * g.ww + c];
          if (dv != 0) atomicAdd(src + (size_t)r * g.WP + c, dv);
        }
    }
    __syncthreads();  // diagonal d is in the plane
  }
}

template <int KIND>
int launch(int* planes, const int* props, const int* scal, int nplanes,
           const Geom& g, int threads, size_t smem, cudaStream_t st) {
  auto kern = wavefront_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<nplanes, threads, smem, st>>>(planes, props, scal, g);
  return (int)cudaGetLastError();
}

}  // namespace

// The limits the launch takes; the wrapper checks against them first.
extern "C" int dsv2t_wavefront_limits(int* max_threads, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *max_threads = kMaxThreads;
  return (int)err;
}

// Runs the wavefront of `kind` (0 intra, 1 luma, 2 chroma) in place on
// `planes` on `stream`; returns cudaGetLastError() (0 = ok). geom = (pw,
// ph, tw, th, ntx, nty, L, nd, mr, mc, HP, WP, wh, ww, NP). Allocates
// nothing, does not sync.
extern "C" int dsv2t_wavefront_filter(int kind, int* planes, const int* props,
                                      const int* scal, int nplanes,
                                      const int* geom, void* stream) {
  Geom g;
  g.pw = geom[0]; g.ph = geom[1]; g.tw = geom[2]; g.th = geom[3];
  g.ntx = geom[4]; g.nty = geom[5]; g.L = geom[6]; g.nd = geom[7];
  g.mr = geom[8]; g.mc = geom[9]; g.HP = geom[10]; g.WP = geom[11];
  g.wh = geom[12]; g.ww = geom[13]; g.NP = geom[14];
  if (nplanes <= 0 || g.L <= 0 || g.NP > 10 || g.tw < 4 || g.th < 4 ||
      g.mr < 8 || g.mc < 8)
    return (int)cudaErrorInvalidValue;
  // an odd stride keeps the lanes' same-offset accesses on distinct banks
  g.wstride = (g.wh * g.ww) | 1;
  const int threads = ((g.L + 31) / 32) * 32;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)g.L * g.wstride * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kIntra:
      return launch<kIntra>(planes, props, scal, nplanes, g, threads, smem,
                            st);
    case kLuma:
      return launch<kLuma>(planes, props, scal, nplanes, g, threads, smem, st);
    case kChroma:
      return launch<kChroma>(planes, props, scal, nplanes, g, threads, smem,
                             st);
  }
  return (int)cudaErrorInvalidValue;
}
