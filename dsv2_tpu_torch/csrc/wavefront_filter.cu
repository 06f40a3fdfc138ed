// The in-loop filter wavefront of the decoder and the encoder's
// reconstruction loop, for Hopper.
//
// Replaces the TPU kernels dsv2_tpu/ops/filters_pl.py::_run_wavefront_pl
// (:273; the skewed plane whole in VMEM) and ::_hbm_call (:368; the plane
// in HBM, each diagonal's strip DMA'd, batched over a grid (B, nd)). One
// launch runs B planes, each plane on one CTA or one thread-block cluster.
// Semantics (plain version: dsv2_tpu_torch/ops/filters.py
// wavefront_filter_plain): the reference's raster scan of 4x4 tiles (intra
// dering, inter luma cleanup + de-gradient sharpen) or of whole blocks
// (inter chroma), reproduced as a wavefront over the anti-diagonals
// d = i + 2*j of the tile grid. A tile reads its (th+8, tw+8) window around
// the tile; same-diagonal tiles write disjoint pixels, but a tile's window
// can overlap pixels its same-diagonal neighbour writes, so every window of
// a diagonal is read before any write of that diagonal.
//
// Layout: plane (B, HP, WP) uint8 (the wrapper's copy of the int32 plane,
// whose values lie in [0, 255]), unskewed, the visible plane at (mr, mc)
// inside zero margins (writes there persist, as in the twin). props (B,
// NP, nty, ntx) int32 per tile, scal (B, 8) int32 per plane. The launch
// plan (ring width, cluster, threads, shared bytes) comes from
// ops/filters.py wavefront_plan.
//
// What bounds it on an H100: by bytes, an FHD luma plane read once and
// written once is ~4 MB as uint8 (~1.3 us at 3.35 TB/s); the arithmetic
// is a few thousand integer operations per tile. The time is set by the
// chain of nd dependent diagonals (1,015 at FHD luma), each run by one
// SM: per diagonal, the integer work of its lanes (the SM issues two
// 32-bit integer warp instructions per clock; luma lanes diverge between
// the intra, inter and sharpen paths), then two barriers.
// Design:
// - the moving front of the plane lives in shared memory. Band b (tile row
//   b - mr/th) is skewed right by 2*tw*b, as the twin skews it; diagonal d's
//   windows then lie in one strip of 5*tw+8 skewed columns starting at
//   S0(d) - 2*tw, S0(d) = mc - 4 + tw*(d + 2*mr/th), which advances tw per
//   diagonal. Every plane row keeps a uint8 ring of R = 6*tw+8 skewed
//   columns: the strip plus the tw columns of the next diagonal, which all
//   threads load (4 pixels a word) while the current diagonal runs and
//   store into the ring after its barrier, into the slots of the tw
//   columns that left the strip, written back to the plane first. Each
//   pixel crosses device memory once in and once out; window reads,
//   steps and write-backs stay in shared memory.
// - each lane (tile) copies from the ring the words of its window its step
//   reads into a private uint8 window (windows start on 4-byte skewed
//   columns), runs the
//   step there (a boundary's four lines loaded, filtered and stored
//   together), and after a barrier writes back the pixels its step may
//   write (the cross of rows 4..th+3 x cols 2..10 and rows 2..10 x cols
//   4..tw+3 of the window; disjoint between same-diagonal lanes), so no
//   atomics. A ring row starts one word later per band, so the lanes of a
//   diagonal (rows th apart) hit distinct banks.
// - lanes loop over threads, so the lane count does not cap the layout.
// - a plane whose ring and windows exceed one CTA's shared memory (e.g.
//   3840x2160 4:4:4 chroma) runs on a thread-block cluster of C CTAs: CTA
//   k owns tile rows [k*J, (k+1)*J) and their plane rows; windows and
//   write-backs that cross a strip edge go to the neighbour's ring through
//   distributed shared memory, and cluster barriers replace __syncthreads.
// - a plane that no cluster of 8 CTAs holds (a very tall one, e.g.
//   16x16384 4:4:4 chroma in 32x32 blocks) keeps its ring rows in a
//   scratch buffer in global memory that the wrapper allocates (the
//   counterpart of the twin's HBM-resident _hbm_call): the same kernel on
//   one CTA (GR), the lanes' windows in shared memory (or, if even they
//   do not fit, after the ring in the scratch), the barriers CTA barriers
//   ordered by a block-scope fence. Each diagonal moves only the ring rows
//   whose entering or leaving columns lie in the plane (a few bands of a
//   tall plane): the other rows hold columns no window reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
constexpr int kMaxCluster = 8;
constexpr int kPrefetch = 12;  // next-diagonal words (4 px) per thread
constexpr int kGeomInts = 25;

// The layout (ops/filters.py _Lay), NP, and the plan (wavefront_plan):
// ring width R (bytes, a multiple of 4), cluster size C, tile rows per CTA
// J, lane windows per CTA LC, window stride (bytes), ring rows per CTA,
// threads, dynamic shared bytes per CTA, the ring's place (0 shared, 1 the
// global scratch) and the scratch bytes per plane.
struct Geom {
  int pw, ph, tw, th, ntx, nty, L, nd, mr, mc, HP, WP, wh, ww, NP;
  int R, C, J, LC, wstride, rows, threads, smem, ring, scratch;
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

// One line of 11 taps c[0..10] at offsets -3..7 around a boundary at
// offset 0: the boundary rewrites taps 1..4 (offsets -2..1), the interior
// boundary at offset 4 taps 6..9 (offsets 3..6) (ref: bmc.c:51-191). The
// interior reads only taps the boundary does not write.
__device__ __forceinline__ void edge_pair(int* c, int thE, int thM,
                                          bool in_edge) {
  const int e2 = c[0], e1 = c[1], e0 = c[2], i0 = c[3], i1 = c[4], i2 = c[5];
  const int i1b = c[6], i0b = c[7], e0b = c[8], e1b = c[9], e2b = c[10];
  const int avg = lpf6(e0, i0, e1, i1);
  if (flat6(e2, e1, e0, i0, i1, i2, avg, thE)) {
    const int a5 = avg * 5;
    c[1] = (3 * (avg + e1) + 2 * e2 + 4) >> 3;
    c[2] = (a5 + 2 * e1 + e2 + 4) >> 3;
    c[3] = avg;
    c[4] = (a5 + 2 * i1 + i2 + 4) >> 3;
  }
  const int avgb = lpf6(e0b, i0b, e1b, i1b);
  if (in_edge && flat6(e2b, e1b, e0b, i0b, i1b, i2, avgb, thM)) {
    const int a5b = avgb * 5;
    c[6] = (a5b + 2 * i1b + i2 + 4) >> 3;
    c[7] = avgb;
    c[8] = (a5b + 2 * e1b + e2b + 4) >> 3;
    c[9] = (3 * (avgb + e1b) + 2 * e2b + 4) >> 3;
  }
}

// Four independent lines of a boundary at once: every tap read first, so
// the four lines' load latencies and arithmetic overlap. Line l's tap k
// sits at p[l * ls + (k - 3) * ts].
__device__ __forceinline__ void edge_lines(uint8_t* p, int ls, int ts,
                                           int thE, int thM, bool in_edge) {
  int c[4][11];
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int k = 0; k < 11; ++k) c[l][k] = p[l * ls + (k - 3) * ts];
#pragma unroll
  for (int l = 0; l < 4; ++l) edge_pair(c[l], thE, thM, in_edge);
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int k = 1; k < 10; ++k)
      if (k != 5) p[l * ls + (k - 3) * ts] = (uint8_t)c[l][k];
}

// Vertical boundary at window col co, rows ro..ro+3 (ref: bmc.c:51-119).
__device__ __forceinline__ void hfilt(uint8_t* W, int ww, int ro, int co,
                                      bool edge, int thE, int thM,
                                      bool guard, bool in_edge) {
  if (!(guard && thM > 0 && !(edge && thE <= 0))) return;
  edge_lines(W + ro * ww + co, ww, 1, edge ? thE : thM, thM, in_edge);
}

// Horizontal boundary at window row ro, cols co..co+3 (ref: bmc.c:121-191).
__device__ __forceinline__ void vfilt(uint8_t* W, int ww, int ro, int co,
                                      bool edge, int thE, int thM,
                                      bool guard, bool in_edge) {
  if (!(guard && thM > 0 && !(edge && thE <= 0))) return;
  edge_lines(W + ro * ww + co, 1, ww, edge ? thE : thM, thM, in_edge);
}

struct Quads {
  int d0, d1, d2, d3;
};

__device__ __forceinline__ Quads quads(const uint8_t* t, int ww) {
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
__device__ __forceinline__ void tile_energy(const uint8_t* t, int ww,
                                            int& sh, int& sv, int& slh,
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
__device__ __forceinline__ int dsfactor(const uint8_t* t, int ww) {
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
// lo/hi are the first/last occupied of the 16 bins v >> 4: every value is
// in [0, 255], so they are the least and the greatest bin.
__device__ __forceinline__ void degrad(uint8_t* t, int ww) {
  int v[16];
  int lo = 15, hi = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    v[q] = t[(q >> 2) * ww + (q & 3)];
    lo = min(lo, v[q] >> 4);
    hi = max(hi, v[q] >> 4);
  }
  if (!(lo < hi)) return;
  int hl = 0, hh = 0, sl = 0, sh = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int b = v[q] >> 4;
    if (b == lo) hl += 1, sl += v[q];
    if (b == hi) hh += 1, sh += v[q];
  }
  const int alo = max(floordiv(sl, hl), 1);
  const int ahi = max(floordiv(sh, hh), 1);
  const int mid = (alo + ahi + 1) >> 1;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    // C division truncates, as the twin's divt does
    if (v[q] < mid)
      t[(q >> 2) * ww + (q & 3)] = v[q] + (hl * (alo - v[q])) / 16;
    else if (v[q] > mid)
      t[(q >> 2) * ww + (q & 3)] = v[q] + (hh * (ahi - v[q])) / 16;
  }
}

__device__ __forceinline__ int curve_tex(int tt) {
  return tt < 8 ? (8 - tt) * 8 : (tt > 192 ? 0 : tt - 7);
}

// ref: bmc.c:390-457. sc = (fq, fthresh * do_filter).
__device__ __forceinline__ void intra_step(uint8_t* W, const Geom& g,
                                          const int* pr, int i, int j,
                                          const int* sc) {
  constexpr int ww = 12;   // 4x4 tiles
  const int fq = sc[0], fth = sc[1];
  const int flags = pr[0];
  uint8_t* t = W + 4 * ww + 4;
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
__device__ __forceinline__ void luma_step(uint8_t* W, const Geom& g,
                                         const int* pr, int i, int j,
                                         const int* sc) {
  constexpr int ww = 12;   // 4x4 tiles
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
  uint8_t* t = W + 4 * ww + 4;
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
__device__ __forceinline__ void chroma_step(uint8_t* W, const Geom& g,
                                           const int* pr, int i, int j,
                                           const int* sc) {
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

template <bool CL, bool GR = false>
__device__ __forceinline__ void front_sync() {
  if constexpr (CL) {
    cg::this_cluster().sync();
  } else {
    if constexpr (GR) __threadfence_block();  // the ring in global memory
    __syncthreads();
  }
}


// a / d, by a shift where d is a power of two (sh >= 0; every codec
// layout's tiles are)
__device__ __forceinline__ int divp(int a, int d, int sh) {
  return sh >= 0 ? a >> sh : a / d;
}

// What the threads of one CTA share about the layout.
struct Ctx {
  uint8_t* ring;  // this CTA's ring rows
  uint8_t* P;     // this CTA's plane (uint8)
  int row0;       // plane row of ring row 0
  int tw, th, thsh, WP, R, Rw;
  // ring row rl: Rw words, one padding word per band before it, so rows
  // th apart (the lanes of a diagonal) fall on distinct banks
  __device__ __forceinline__ uint32_t* row(int rl) const {
    return reinterpret_cast<uint32_t*>(ring) + rl * Rw + divp(rl, th, thsh);
  }
  // unskewed plane column of skewed column s in ring row rl
  __device__ __forceinline__ int col(int rl, int s) const {
    return s - 2 * tw * divp(row0 + rl, th, thsh);
  }
  // the 4 pixels at skewed columns s..s+3 of ring row rl as one word (s
  // and the plane's column a multiple of 4): 0 outside the plane, which no
  // window reads
  __device__ __forceinline__ uint32_t load(int rl, int s) const {
    const int x = col(rl, s);
    if (x < 0 || x >= WP) return 0;
    return *reinterpret_cast<const uint32_t*>(P + (size_t)(row0 + rl) * WP +
                                              x);
  }
  __device__ __forceinline__ void store(int rl, int s, uint32_t w) const {
    const int x = col(rl, s);
    if (x >= 0 && x < WP)
      *reinterpret_cast<uint32_t*>(P + (size_t)(row0 + rl) * WP + x) = w;
  }
};

__device__ __forceinline__ int wrap(int s, int R) {
  return s < 0 ? s + R : (s >= R ? s - R : s);
}

// Plane row r's ring row, in whichever CTA of the cluster owns it.
template <bool CL>
__device__ __forceinline__ uint32_t* ring_row(const Ctx& x, const Geom& g,
                                              int r) {
  if constexpr (!CL) {
    return x.row(r);
  } else {
    const int span = g.J * g.th;
    const int k = r < g.mr + span ? 0 : min((r - g.mr) / span, g.C - 1);
    const int r0 = k == 0 ? 0 : g.mr + k * span;
    return cg::this_cluster().map_shared_rank(x.row(r - r0), k);
  }
}

// The step's props of tile (i, j).
template <int NP>
__device__ __forceinline__ void load_props(int* pr, const int* pb,
                                           size_t ptile, int ntx, int i,
                                           int j) {
#pragma unroll
  for (int q = 0; q < NP; ++q) pr[q] = pb[q * ptile + (size_t)j * ntx + i];
}

__device__ __forceinline__ int first_lane(const Geom& g, int d, int jlo) {
  return max(max(0, (d - (g.ntx - 1) + 1) >> 1), jlo);
}

template <int KIND, bool CL, bool GR>
__global__ void __launch_bounds__(kMaxThreads)
wavefront_kernel(uint8_t* __restrict__ planes,
                 const int* __restrict__ props,
                 const int* __restrict__ scal,
                 uint8_t* __restrict__ scratch,
                 const __grid_constant__ Geom g) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kNP = KIND == kIntra ? 1 : (KIND == kLuma ? 10 : 5);
  const int C = CL ? g.C : 1;
  const int b = blockIdx.x / C;
  const int k = CL ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, T = blockDim.x;
  // intra and luma tiles are 4x4: compile-time window offsets for them
  constexpr bool kTile4 = KIND != kChroma;
  const int tw = kTile4 ? 4 : g.tw, th = kTile4 ? 4 : g.th;
  const int wh = th + 8, ww = tw + 8, ncw = ww >> 2;
  // the most window words per row, and whole write-back words per row
  constexpr int kCW = kTile4 ? 3 : 10, kWB = kTile4 ? 1 : 8;
  const int R = 6 * tw + 8, Rw = R >> 2;
  const int span = g.J * th;
  const int row0 = k == 0 ? 0 : g.mr + k * span;
  const int row1 = k == C - 1 ? g.HP : g.mr + (k + 1) * span;
  const int nrows = row1 - row0;
  const int jlo = k * g.J, jhi = min(g.nty, (k + 1) * g.J);
  uint8_t* ring = GR ? scratch + (size_t)b * g.scratch : smem;
  uint8_t* wins =
      GR && g.smem == 0
          ? ring + 4 * ((size_t)g.rows * Rw + g.rows / th + 1)
          : smem + (size_t)g.smem - (size_t)g.LC * g.wstride;
  const int thsh = (th & (th - 1)) ? -1 : __ffs(th) - 1;
  const Ctx x{ring, planes + (size_t)b * g.HP * g.WP, row0, tw, th, thsh,
              g.WP, R, Rw};
  // the ring rows [lo, hi) a diagonal moves for the columns [s, s + tw):
  // all of them, or under GR the bands whose plane columns of those lie in
  // [0, WP) (band k's plane column is s - 2*tw*k; C = 1, so row0 = 0)
  auto moved = [&](int s, int& lo, int& hi) {
    lo = 0;
    hi = nrows;
    if constexpr (GR) {
      lo = max(lo, (floordiv(s - g.WP, 2 * tw) + 1) * th);
      hi = min(hi, (floordiv(s + tw - 4, 2 * tw) + 1) * th);
      hi = max(hi, lo);
    }
  };
  const size_t ptile = (size_t)g.nty * g.ntx;
  const int* pb = props + (size_t)b * kNP * ptile;
  int sc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sc[q] = scal[b * 8 + q];
  const int sbase = g.mc - 4 + 2 * tw * (g.mr / th);   // S0(0)

  // strip 0 (skewed columns S0(0) - 2tw .. S0(0) + 3tw + 8) into the ring
  {
    const int w5 = (5 * tw + 8) >> 2, n = nrows * w5;
    for (int it = tid; it < n; it += T) {
      const int rl = it / w5, s = sbase - 2 * tw + 4 * (it - rl * w5);
      x.row(rl)[(s % R) >> 2] = x.load(rl, s);
    }
  }
  // the first lane's props of diagonal 0 (then always one diagonal ahead)
  int prn[kNP];
  {
    const int j = first_lane(g, 0, jlo) + tid;
    if (j <= min(0, jhi - 1))
      load_props<kNP>(prn, pb, ptile, g.ntx, -2 * j, j);
  }
  front_sync<CL, GR>();

  const int nw = tw >> 2;                      // words per row per diagonal
  const int nwsh = (nw & (nw - 1)) ? -1 : __ffs(nw) - 1;
  uint32_t pf[kPrefetch];
  for (int d = 0; d < g.nd; ++d) {
    const int s0 = sbase + tw * d;             // S0(d)
    const int s0m = s0 % R;
    const bool next = d + 1 < g.nd;
    // ring word of the columns diagonal d-1 left, which the columns of
    // diagonal d+1 (S0(d) + 3tw + 8 ..., R = 6tw + 8 further) take over
    const int wslot = wrap(s0m - 3 * tw, R) >> 2;
    const int sin = s0 + 3 * tw + 8;
    int rin, rin1, rout, rout1;
    moved(sin, rin, rin1);
    moved(s0 - 3 * tw, rout, rout1);
    const int nmove = (rin1 - rin) * nw;
    // phase A: the columns of diagonal d+1 start on their way; the columns
    // diagonal d-1 left go back to the plane
    if (next) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int it = tid + u * T;
        if (it < nmove) {
          const int rl = divp(it, nw, nwsh);
          pf[u] = x.load(rin + rl, sin + 4 * (it - rl * nw));
        }
      }
    }
    if (d > 0) {
      for (int it = tid; it < (rout1 - rout) * nw; it += T) {
        const int rl = divp(it, nw, nwsh), q = it - rl * nw;
        x.store(rout + rl, s0 - 3 * tw + 4 * q,
                x.row(rout + rl)[wrap(wslot + q, Rw)]);
      }
    }
    const int j0 = first_lane(g, d, jlo);
    const int j1 = min(d >> 1, jhi - 1);
    // each lane: its window from the ring (the state after diagonal d-1),
    // then its step on the private copy
    for (int j = j0 + tid; j <= j1; j += T) {
      const int i = d - 2 * j;
      int pr[kNP];
      if (j == j0 + tid) {
#pragma unroll
        for (int q = 0; q < kNP; ++q) pr[q] = prn[q];
      } else {
        load_props<kNP>(pr, pb, ptile, g.ntx, i, j);
      }
      uint8_t* W = wins + (size_t)(j - j0) * g.wstride;
      const int rtop = g.mr + j * th - 4;
      // the words the step reads (rows 4..th+3: words 0..2, the taps of
      // the vertical boundaries; rows 1..11: words 1..tw/4, the taps of
      // the horizontal ones), 4 rows at a time, loads before stores
      for (int r0 = 0; r0 < wh; r0 += 4) {
        uint32_t v[4][kCW];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + q;
          const bool mid = r >= 4 && r < th + 4, tap = r >= 1 && r < 12;
          const int wlo = mid ? 0 : 1;
          const int whi = mid ? max(3, ncw - 1) : (tap ? ncw - 1 : 0);
          const int band = r < 4 ? -1 : (r < th + 4 ? 0 : 1);
          const uint32_t* src = ring_row<CL>(x, g, rtop + r);
          int w = wrap(s0m + band * 2 * tw, R) >> 2;
#pragma unroll
          for (int c = 0; c < kCW; ++c) {
            if (c >= wlo && c < whi) v[q][c] = src[w];
            if (++w == Rw) w = 0;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + q;
          const bool mid = r >= 4 && r < th + 4, tap = r >= 1 && r < 12;
          const int wlo = mid ? 0 : 1;
          const int whi = mid ? max(3, ncw - 1) : (tap ? ncw - 1 : 0);
          uint32_t* dst = reinterpret_cast<uint32_t*>(W + r * ww);
#pragma unroll
          for (int c = 0; c < kCW; ++c)
            if (c >= wlo && c < whi) dst[c] = v[q][c];
        }
      }
      if constexpr (KIND == kIntra) intra_step(W, g, pr, i, j, sc);
      if constexpr (KIND == kLuma) luma_step(W, g, pr, i, j, sc);
      if constexpr (KIND == kChroma) chroma_step(W, g, pr, i, j, sc);
    }
    front_sync<CL, GR>();   // every window of diagonal d is read
    // phase B: each lane's writable pixels back into the ring
    for (int j = j0 + tid; j <= j1; j += T) {
      const uint8_t* W = wins + (size_t)(j - j0) * g.wstride;
      const int rtop = g.mr + j * th - 4;
      const int rend = max(11, th + 4);
#pragma unroll 3
      for (int r = 2; r < rend; ++r) {
        // window cols [c0, c1) of row r: 2 head bytes (c0 = 2), whole
        // words from col 4, 3 tail bytes (c1 = 11)
        const bool inA = r >= 4 && r < th + 4, inB = r < 11;
        const bool head = inA;
        const int c1 = max(inA ? 11 : 0, inB ? tw + 4 : 0);
        const int nwd = ((c1 & ~3) - 4) >> 2;
        const bool tail = (c1 & 3) != 0;
        const int band = r < 4 ? -1 : (r < th + 4 ? 0 : 1);
        const uint8_t* Wr = W + r * ww;
        uint32_t v[kWB];
        uint8_t hb[2] = {0, 0}, tb[3] = {0, 0, 0};
        if (head) hb[0] = Wr[2], hb[1] = Wr[3];
#pragma unroll
        for (int q = 0; q < kWB; ++q)
          if (q < nwd) v[q] = reinterpret_cast<const uint32_t*>(Wr)[1 + q];
        if (tail) tb[0] = Wr[8], tb[1] = Wr[9], tb[2] = Wr[10];
        uint32_t* dst = ring_row<CL>(x, g, rtop + r);
        const int w0 = wrap(s0m + band * 2 * tw, R) >> 2;   // window col 0
        if (head) {
          uint8_t* db = reinterpret_cast<uint8_t*>(dst + w0);
          db[2] = hb[0];
          db[3] = hb[1];
        }
        int w = w0 + 1 == Rw ? 0 : w0 + 1;
#pragma unroll
        for (int q = 0; q < kWB; ++q) {
          if (q < nwd) dst[w] = v[q];
          if (++w == Rw) w = 0;
        }
        if (tail) {
          uint8_t* db = reinterpret_cast<uint8_t*>(dst + wrap(w0 + 2 - Rw,
                                                              Rw));
          db[0] = tb[0];
          db[1] = tb[1];
          db[2] = tb[2];
        }
      }
    }
    if (next) {
      // the columns of diagonal d+1 into the words diagonal d-1 left
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int it = tid + u * T;
        if (it < nmove) {
          const int rl = divp(it, nw, nwsh);
          x.row(rin + rl)[wrap(wslot + it - rl * nw, Rw)] = pf[u];
        }
      }
      for (int it = tid + kPrefetch * T; it < nmove; it += T) {
        const int rl = divp(it, nw, nwsh), q = it - rl * nw;
        x.row(rin + rl)[wrap(wslot + q, Rw)] = x.load(rin + rl, sin + 4 * q);
      }
      // and the first lane's props of diagonal d+1
      const int j = first_lane(g, d + 1, jlo) + tid;
      if (j <= min((d + 1) >> 1, jhi - 1))
        load_props<kNP>(prn, pb, ptile, g.ntx, d + 1 - 2 * j, j);
    }
    front_sync<CL, GR>();   // diagonal d is in the ring
  }
  // the last strip back to the plane (no other CTA touches this one's ring
  // after the last barrier)
  {
    const int w5 = (5 * tw + 8) >> 2, n = nrows * w5;
    const int sl = sbase + tw * (g.nd - 1) - 2 * tw;
    for (int it = tid; it < n; it += T) {
      const int rl = it / w5, s = sl + 4 * (it - rl * w5);
      x.store(rl, s, x.row(rl)[(s % R) >> 2]);
    }
  }
}

template <int KIND, bool CL, bool GR>
int launch(uint8_t* planes, const int* props, const int* scal,
           uint8_t* scratch, int nplanes, const Geom& g, cudaStream_t st) {
  auto kern = wavefront_kernel<KIND, CL, GR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nplanes * g.C, 1, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, planes, props, scal, scratch, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(uint8_t* planes, const int* props, const int* scal,
                uint8_t* scratch, int nplanes, const Geom& g,
                cudaStream_t st) {
  if (g.ring)
    return launch<KIND, false, true>(planes, props, scal, scratch, nplanes,
                                     g, st);
  if (g.C > 1)
    return launch<KIND, true, false>(planes, props, scal, scratch, nplanes,
                                     g, st);
  return launch<KIND, false, false>(planes, props, scal, scratch, nplanes, g,
                                    st);
}

}  // namespace

// The opt-in shared bytes per block of the current device; the planner
// fits the plan to it.
extern "C" int dsv2t_wavefront_limits(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// Runs the wavefront of `kind` (0 intra, 1 luma, 2 chroma) in place on
// `planes` on `stream`; returns the launch's cudaError_t (0 = ok). geom =
// (pw, ph, tw, th, ntx, nty, L, nd, mr, mc, HP, WP, wh, ww, NP, R, C, J,
// LC, wstride, rows, threads, smem, ring, scratch). With ring = 1, scratch
// holds nplanes * geom's scratch bytes (contents not read) for the rings
// in global memory; else it may be null. Allocates nothing, does not sync.
extern "C" int dsv2t_wavefront_filter(int kind, uint8_t* planes,
                                      const int* props, const int* scal,
                                      uint8_t* scratch, int nplanes,
                                      const int* geom, void* stream) {
  Geom g;
  int* gi = reinterpret_cast<int*>(&g);
  for (int q = 0; q < kGeomInts; ++q) gi[q] = geom[q];
  const bool ok =
      nplanes > 0 && g.NP == (kind == kIntra ? 1 : (kind == kLuma ? 10 : 5)) &&
      (kind == kChroma || (g.tw == 4 && g.th == 4)) && g.tw >= 4 &&
      g.th >= 4 && g.tw <= 32 && g.th <= 32 &&
      g.tw % 4 == 0 && g.th % 4 == 0 && g.ww == g.tw + 8 &&
      g.wh == g.th + 8 && g.mr >= 8 && g.mr % g.th == 0 && g.mc % 4 == 0 &&
      g.mc >= 8 && g.ntx >= 1 && g.nty >= 1 &&
      g.R == 6 * g.tw + 8 &&
      g.C >= 1 && g.C <= kMaxCluster && g.J >= 1 &&
      (g.C - 1) * g.J < g.nty && g.J * g.C >= g.nty && g.LC >= 1 &&
      g.LC >= min(g.L, g.J) && g.wstride >= g.wh * g.ww &&
      g.wstride % 4 == 0 && g.threads >= 32 && g.threads <= kMaxThreads &&
      g.threads % 32 == 0 && g.HP >= g.mr + g.nty * g.th + 8 &&
      g.WP >= g.mc + g.ntx * g.tw + 4 && g.WP % 4 == 0 &&
      g.rows >= (g.C == 1 ? g.HP : g.mr + g.J * g.th) &&
      reinterpret_cast<uintptr_t>(planes) % 4 == 0;
  const size_t ring = 4 * ((size_t)g.rows * (g.R / 4) + g.rows / g.th + 1);
  const size_t wins = (size_t)g.LC * g.wstride;
  const bool ring_ok =
      g.ring == 0
          ? (size_t)g.smem >= ring + wins
          : g.ring == 1 && g.C == 1 && scratch != nullptr &&
                g.scratch % 16 == 0 &&
                reinterpret_cast<uintptr_t>(scratch) % 16 == 0 &&
                (g.smem == 0 ? (size_t)g.scratch >= ring + wins
                             : (size_t)g.smem >= wins &&
                                   (size_t)g.scratch >= ring);
  if (!ok || !ring_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kIntra:
      return launch_kind<kIntra>(planes, props, scal, scratch, nplanes, g,
                                 st);
    case kLuma:
      return launch_kind<kLuma>(planes, props, scal, scratch, nplanes, g,
                                st);
    case kChroma:
      return launch_kind<kChroma>(planes, props, scal, scratch, nplanes,
                                  g, st);
  }
  return (int)cudaErrorInvalidValue;
}
