// The per-block motion search of the encoder's wavefront (hierarchical,
// over anti-diagonals), shared by the Hopper kernels of csrc/hme_search.cu
// (kernels 4/5: one stream) and csrc/hme_gang.cu (kernels 6/7: every
// stream lane of a lockstep flush).
//
// Semantics (plain version: dsv2_tpu_torch/ops/hme_wave.py, held equal to
// dsv2_tpu's XLA wave): a block depends on its left, top and top-left
// neighbours of the same level, so every block of an anti-diagonal can be
// searched at once.
//
// Layout: the bordered uint8 planes of the level (luma; chroma at level 0),
// the parent and temporal fields (2, nbv, nbh) int32, the global motion
// (gx, gy) on the device, and the output grids (NF, nbv, nbh) int32 (fx, fy
// at every level; flags, err, dc, submask, fskip at level 0). A window is
// read at its start clamped into the plane, as the plain version's
// dynamic_slice does, so no read leaves the plane.
//
// One block is searched by a tile of TW threads (Tile<TW>: 32 = a warp, 16
// or 8 = two or four blocks per warp). The tile's threads run the block's
// control flow in step and split every pixel or quad loop between them,
// with shuffle reductions inside the tile (all its threads get every sum,
// so every decision is uniform in the tile; tiles of one warp may diverge,
// so every collective names only the tile's lanes). Each tile reads its
// neighbours, parents and temporal candidates from the grids itself
// (same-level grids through __ldcg: other tiles wrote them). The tile's
// slice of shared memory holds the block's source window for the whole
// search (an upper level's slice, kUpperTileBytes, holds only that: its
// candidates and refine probes read the reference plane through L1) and,
// at the base level (kTileBytes), the half-pel grid of a
// subpel search and the windows a phase stages (stage_k: every load of a
// window issued before any is used, one round trip to memory instead of
// one per loop iteration).
//
// The chain of one block's search is kept short: the metrics that do not
// depend on each other are computed in one pass with independent
// accumulators and interleaved reductions, then the reference's order
// rules are applied to the scores (the candidates' duplicate skip and
// first strict minimum, the refine's first improvement in kRect order,
// the subpel picks, the intra subblock loop); the integer square root is
// the float root plus an exact integer correction. And the search is split
// around the neighbours: block_pre (the source window, the psy features,
// every candidate that is not a neighbour's vector, the good-enough
// metric) and, at the base level, the probes of the first subpel refine
// run before the block waits for its left, top and top-left blocks;
// block_post (the neighbours' candidates, the first strict minimum, the
// good-enough test, the refine) and the decisions after. At an upper
// level the median predictor is zero (it reads cells no block of the
// level writes), so no score depends on the neighbours but theirs:
// block_pre also runs the refine from the best of its candidates, which
// block_post keeps unless a neighbour's vector becomes the start.
//
// Every level runs on the dataflow scheduler of csrc/hme_sched.cuh:
// upper_dag (kernels 4/6) over an upper level's ca x cb blocks (at
// multiples of the level's step), level0_dag (kernels 5/7) over the base
// level's blocks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hme_sched.cuh"
#include "metr.cuh"

namespace {

#define I32MAX 0x7FFFFFFF
#define BRD 32          // FRAME_BORDER
#define SRC_DC_PRED 0x100
#define MASK_ALL_INTRA 15
#define SPD 17
#define HGS 35          // half-pel grid side (34 + a zero row/column)
#define FULL 0xFFFFFFFFu

constexpr int kDagThreads = 128;  // a run_dag CTA: at most 4 warps
// warps per SM a run_dag launch takes by default: 2 were fastest at FHD
// level 0 and on 8 CIF lanes on an H100 (1, 2, 4, 8 and 16 tried with
// tools/torch_profile.py --hme; PERF.md, kernels 5/7), and at the upper
// levels any count from 1 per SM up is within the noise of the best
// (kernels 4/6)
constexpr int kDagWarpsPerSm = 2;
constexpr int kHgBytes = 1232;    // HGS * HGS rounded up to 16
constexpr int kSrcBytes = 32 * 32;  // the block's source window
constexpr int kStageBytes = 4 * 32 * 32;  // the windows one phase stages
// a base-level tile's shared slice: half-pel grid, source, staged windows
constexpr int kTileBytes = kHgBytes + kSrcBytes + kStageBytes;
constexpr int kUpperTileBytes = kSrcBytes;  // an upper-level tile's slice
constexpr int kCandBatch = 8;     // candidates scored in one pass
constexpr int kStageUnroll = 8;   // loads a lane issues per window at once

struct G {  // the wrapper's GEOM order (ops/hme_gpu.py)
  int nbh, nbv, blk_w, blk_h, vid_w, vid_h, hs, vs, effort, lossless, levels,
      has_tmv, skip_neg, level, fw, fh, W, H, CW, CH, quant, skip_thresh,
      psyf, b2sr;
};
constexpr int kGeomLen = 24;

struct Plane {
  const uint8_t* p;
  int W, H;
};

struct Lv {
  Plane src, ref, ogr, su, sv, ru, rv;
  const int* parent;  // (2, nbv, nbh)
  const int* tmv;     // (2, nbv, nbh)
  const int* gxy;     // (2,)
  int* out;           // (NF, nbv, nbh)
};

// a window of a plane in device memory: its first sample, the plane
// stride, its static height and log2 of its static (power-of-two) width
struct Win {
  const uint8_t* p;
  int s, h, lw;
};
// a window copied into the tile's shared memory (same fields)
struct SWin {
  const uint8_t* p;
  int s, h, lw;
};

// int32 arithmetic that wraps like XLA's
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int fdiv(int a, int b) {  // floor, b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int divt(int a, int b) { return a / b; }
__device__ __forceinline__ int sar_r2(int v) { return (v + 2) >> 2; }

__device__ __forceinline__ Win win(const Plane& pl, int x, int y, int h,
                                   int w) {
  int y0 = min(max(y + BRD, 0), pl.H - h);
  int x0 = min(max(x + BRD, 0), pl.W - w);
  return Win{pl.p + (size_t)y0 * pl.W + x0, pl.W, h, __ffs(w) - 1};
}
__device__ __forceinline__ int at(const Win& a, int r, int c) {
  return __ldg(a.p + (size_t)r * a.s + c);
}
__device__ __forceinline__ int at(const SWin& a, int r, int c) {
  return a.p[r * a.s + c];
}
// a sample of a window in shared memory (S) or device memory
template <bool S>
__device__ __forceinline__ int ld(const uint8_t* p) {
  if constexpr (S) return *p;
  else return __ldg(p);
}

// floor(sqrt(n)) for every uint32 n (ref: hme.c:100-124): the float root
// is within 1 of it (the conversion and the root each round by a relative
// 2^-24 of a root below 2^16), and one integer step each way makes it
// exact (tests/test_torch_cuda.py checks all 2^32 inputs on the card)
__device__ __forceinline__ unsigned isqrt_u32(unsigned n) {
  unsigned r = min((unsigned)__fsqrt_rn(__uint2float_rn(n)), 65535u);
  if (r * r > n) return r - 1;
  return (unsigned long long)(r + 1) * (r + 1) <= n ? r + 1 : r;
}

__device__ __forceinline__ int metric_return(unsigned acc, int bw, int bh) {
  return (int)isqrt_u32(acc) * (bw * bh) / max((bw + bh + 1) >> 1, 1);
}

__device__ __forceinline__ int seg_bits(int v) {
  v = iabs(v) + 1;
  return (31 - __clz(v)) * 2 + 2;
}

// (ref: dsv.c:356-371 + hme.c:354-366)
__device__ int mv_cost(const G& g, int px, int py, int mx, int my, int sqr) {
  int bits = seg_bits(mx - px) + seg_bits(my - py);
  bits = wadd(bits, wmul(bits, g.b2sr) >> 7);
  if (sqr) bits = wmul(bits, bits);
  const int cost = min(bits, 1 << 19);
  if (sqr) return wmul(cost, (g.quant * g.quant) >> 12) >> 10;
  return wmul(wmul(3, cost), g.quant) >> 12;
}

__device__ __forceinline__ bool invalid_block(int bx, int by, int bw, int bh,
                                              int pad, int fw, int fh) {
  return bx - pad < -BRD || by - pad < -BRD || bx + bw + pad >= fw + BRD ||
         by + bh + pad >= fh + BRD;
}

__device__ __forceinline__ int grid_at(const int* f, const G& g, int x, int y) {
  x = min(max(x, 0), g.nbh - 1);
  y = min(max(y, 0), g.nbv - 1);
  return f[y * g.nbh + x];
}
// same-level fields, written by other tiles: bypass L1
__device__ __forceinline__ int out_at(const Lv& L, const G& g, int fld, int x,
                                      int y) {
  x = min(max(x, 0), g.nbh - 1);
  y = min(max(y, 0), g.nbv - 1);
  return __ldcg(L.out + (fld * g.nbv + y) * g.nbh + x);
}

__device__ __forceinline__ int pred3(int left, int top, int topleft) {
  int dif = left + top - topleft;
  return iabs(dif - left) < iabs(dif - top) ? left : top;
}

__constant__ int kRectX[9] = {0, 1, -1, 0, 0, -1, 1, -1, 1};
__constant__ int kRectY[9] = {0, 0, 0, 1, -1, -1, -1, 1, 1};
__constant__ int kPtsX[9] = {0, -2, 2, 0, 0, -2, 2, 2, -2};
__constant__ int kPtsY[9] = {0, 0, 0, -2, 2, -2, 2, -2, 2};

struct Res {
  int bx, by, bw, bh, dx, dy, best, good, lax, lay, mbias, var_src, avg_src,
      ew, tw, aw, px, py;
};

// one 2x2 quad of a source: its samples, mean and texture
struct Quad {
  int a1, a2, a3, a4, s0, ta;
};
__device__ __forceinline__ Quad quad_of(int a1, int a2, int a3, int a4) {
  return Quad{a1, a2, a3, a4, uavg4(a1, a2, a3, a4),
              uavg4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4),
                    iabs(a4 - a1))};
}
template <class A>
__device__ __forceinline__ Quad quad_at(const A& a, int j, int i) {
  return quad_of(at(a, 2 * j, 2 * i), at(a, 2 * j, 2 * i + 1),
                 at(a, 2 * j + 1, 2 * i), at(a, 2 * j + 1, 2 * i + 1));
}
// the reference's 2x2-quad metric term of quad q against (b1..b4)
__device__ __forceinline__ unsigned quad_metr(const Quad& q, int b1, int b2,
                                              int b3, int b4, int ew, int tw,
                                              int aw) {
  const int s1 = uavg4(b1, b2, b3, b4);
  const int se = uavg4(iabs(q.a1 - b1), iabs(q.a2 - b2), iabs(q.a3 - b3),
                       iabs(q.a4 - b4));
  const int tb = uavg4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4),
                       iabs(b4 - b1));
  return ((unsigned)(se * se) << ew) +
         ((unsigned)((q.ta - tb) * (q.ta - tb)) << tw) +
         ((unsigned)((q.s0 - s1) * (q.s0 - s1)) << aw);
}

// a sample of the (68, 68) quarter-pel grid (ref: hme.c:815-837)
__device__ __forceinline__ int qv(const uint8_t* hg, int y, int x) {
  const uint8_t* h0 = hg + (y >> 1) * HGS + (x >> 1);
  const uint8_t* h1 = h0 + HGS;
  switch (((y & 1) << 1) | (x & 1)) {
    case 0: return h0[0];
    case 1: return (h0[0] + h0[1] + 1) >> 1;
    case 2: return (h0[0] + h1[0] + 1) >> 1;
    default: return uavg4(h0[0], h0[1], h1[0], h1[1]);
  }
}

// the masked cells (r < bh, c < bw) of an (h, 1 << lw) grid, split over
// the tile's lanes; the trip count differs between lanes, so no collective
// in BODY (used inside Tile<TW> only)
#define FOR_CELLS(h, lw, bw, bh, r, c)                                     \
  for (int p_ = lane(), r = 0, c = 0; p_ < ((h) << (lw)); p_ += TW)        \
    if ((r = p_ >> (lw)) < (bh) && (c = p_ & ((1 << (lw)) - 1)) < (bw))

template <int TW>
struct Tile {
  static_assert(TW == 8 || TW == 16 || TW == 32, "a tile is 8, 16 or 32 lanes");

  static __device__ __forceinline__ int lane() { return threadIdx.x & (TW - 1); }
  // the tile's lanes within the warp
  static __device__ __forceinline__ unsigned mask() {
    return TW == 32 ? FULL : ((1u << TW) - 1) << (threadIdx.x & 31 & ~(TW - 1));
  }
  // tile reductions, K sums at once (their reductions interleave): every
  // lane of the tile gets the results
  template <int K, class V>
  static __device__ __forceinline__ void wsum_k(V (&v)[K]) {
#pragma unroll
    for (int o = TW / 2; o; o >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(mask(), v[k], o, TW);
  }
  static __device__ __forceinline__ int bcast0(int v) {
    return __shfl_sync(mask(), v, 0, TW);
  }
  static __device__ __forceinline__ unsigned tile_ballot(bool p) {
    return __ballot_sync(mask(), p) & mask();
  }
  static __device__ __forceinline__ bool tile_any(bool p) {
    return __any_sync(mask(), p);
  }
  static __device__ __forceinline__ void tile_sync() { __syncwarp(mask()); }


  // Copies K windows of one shape (h x 2^lw bytes) into shared memory,
  // window k at buf + k * (h << lw), and returns their views in v. The
  // loads carry no branch (an index past the window reads its last cell)
  // and U of them per lane and window are issued before any is stored, so
  // one round trip to memory brings U * TW cells of every window: a loop
  // that loads a cell and uses it waits a round trip per iteration.
  template <int K, int U = kStageUnroll>
  static __device__ void stage_k(const Win (&w)[K], uint8_t* buf, SWin (&v)[K]) {
    const int lw = w[0].lw, n = w[0].h << lw, wm = (1 << lw) - 1;
    tile_sync();  // every lane is done reading the buffer's last contents
    for (int p0 = 0; p0 < n; p0 += U * TW) {
      int x[K][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = min(p0 + u * TW + lane(), n - 1);
#pragma unroll
        for (int k = 0; k < K; ++k) x[k][u] = at(w[k], p >> lw, p & wm);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * TW + lane();
        if (p < n) {
#pragma unroll
          for (int k = 0; k < K; ++k) buf[k * n + p] = (uint8_t)x[k][u];
        }
      }
    }
    tile_sync();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = SWin{buf + k * n, 1 << lw, w[0].h, lw};
  }

  // sums of squared differences of K windows rp[k] (stride rs; in shared
  // memory if RS) against a (ref: hme.c:198-242), one pass
  template <bool RS = false, int K, class A>
  static __device__ void sse_k(const A& a, const uint8_t* const (&rp)[K], int rs,
                               int bw, int bh, int (&out)[K]) {
    unsigned acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0;
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) {
      const int v = at(a, r, c);
      const size_t o = (size_t)r * rs + c;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = v - ld<RS>(rp[k] + o);
        acc[k] += (unsigned)(d * d);
      }
    }
    wsum_k(acc);
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k] = (bw == 0 || bh == 0) ? I32MAX : (int)acc[k];
  }

  // the reference's 2x2-quad metric accumulators (ref: hme.c:126-196) of
  // K windows rp[k] (stride rs; in shared memory if RS) against one
  // source a, one pass
  template <bool RS = false, int K, class A>
  static __device__ void metr_acc_k(const A& a, const uint8_t* const (&rp)[K],
                                    int rs, int bw, int bh, int ew, int tw, int aw,
                                    unsigned (&acc)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0;
    FOR_CELLS(a.h >> 1, a.lw - 1, bw >> 1, bh >> 1, j, i) {
      const Quad q = quad_at(a, j, i);
      const size_t o = (size_t)(2 * j) * rs + 2 * i;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint8_t* b = rp[k] + o;
        acc[k] += quad_metr(q, ld<RS>(b), ld<RS>(b + 1), ld<RS>(b + rs),
                            ld<RS>(b + rs + 1), ew, tw, aw);
      }
    }
    wsum_k(acc);
  }

  template <bool RS = false, int K, class A>
  static __device__ void metr_k(const A& a, const uint8_t* const (&rp)[K], int rs,
                                int bw, int bh, int ew, int tw, int aw,
                                int (&out)[K]) {
    unsigned acc[K];
    metr_acc_k<RS>(a, rp, rs, bw, bh, ew, tw, aw, acc);
#pragma unroll
    for (int k = 0; k < K; ++k)
      out[k] = (bw == 0 || bh == 0) ? I32MAX : metric_return(acc[k], bw, bh);
  }

  template <class A>
  static __device__ int metr(const A& a, const Win& b, int bw, int bh, int ew,
                             int tw, int aw) {
    const uint8_t* rp[1] = {b.p};
    int out[1];
    metr_k(a, rp, b.s, bw, bh, ew, tw, aw, out);
    return out[0];
  }

  // the search metric of the level: sse above level 1, the quad metric at
  // levels 0 and 1
  template <int K, class A>
  static __device__ __forceinline__ void hier_k(int level, const A& a,
                                                const uint8_t* const (&rp)[K],
                                                int rs, int bw, int bh, int ew,
                                                int tw, int aw, int (&out)[K]) {
    if (level > 1)
      sse_k(a, rp, rs, bw, bh, out);
    else
      metr_k(a, rp, rs, bw, bh, ew, tw, aw, out);
  }

  // block features (ref: hme.c:492-749) of K windows of one shape: two
  // passes (sums and variations, then the deviation from the mean), each
  // with its K reductions interleaved; without VAR only the first (avg,
  // tex)
  template <int K, bool VAR = true, class A>
  static __device__ void feat_detail_k(const A (&a)[K], int bw, int bh,
                                       int (&detail)[K], int (&avg)[K],
                                       int (&tex)[K]) {
    int s[3 * K];  // per window: sum, horizontal and vertical variation
#pragma unroll
    for (int k = 0; k < 3 * K; ++k) s[k] = 0;
    FOR_CELLS(a[0].h, a[0].lw, bw, bh, r, c) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = at(a[k], r, c);
        s[3 * k] += v;
        if (c + 1 < bw) s[3 * k + 1] += iabs(at(a[k], r, c + 1) - v);
        if (r + 1 < bh) s[3 * k + 2] += iabs(at(a[k], r + 1, c) - v);
      }
    }
    wsum_k(s);
    int var[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      avg[k] = s[3 * k] / max(bw * bh, 1);
      tex[k] = max(s[3 * k + 1], s[3 * k + 2]);
      var[k] = 0;
    }
    if (!VAR) return;
    FOR_CELLS(a[0].h, a[0].lw, bw, bh, r, c) {
#pragma unroll
      for (int k = 0; k < K; ++k) var[k] += iabs(at(a[k], r, c) - avg[k]);
    }
    wsum_k(var);
#pragma unroll
    for (int k = 0; k < K; ++k)
      detail[k] = (var[k] >> 1) + max(tex[k] - (var[k] >> 1), 0);
  }

  template <class A>
  static __device__ void feat_detail(const A& a, int bw, int bh, int& detail,
                                     int& avg, int& tex) {
    const A a1[1] = {a};
    int d[1], m[1], t[1];
    feat_detail_k(a1, bw, bh, d, m, t);
    detail = d[0];
    avg = m[0];
    tex = t[0];
  }

  template <class A>
  static __device__ int feat_qtex(const A& a, int bw, int bh) {
    unsigned s[2] = {0, 0};
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) {
      int q = at(a, r, c) >> 4;
      if (c + 1 < bw) {
        int d = q - (at(a, r, c + 1) >> 4);
        s[0] += (unsigned)(d * d);
      }
      if (r + 1 < bh) {
        int d = (at(a, r + 1, c) >> 4) - q;
        s[1] += (unsigned)(d * d);
      }
    }
    wsum_k(s);
    return (int)isqrt_u32(max(s[0], s[1])) / max((bw + bh + 1) >> 1, 1);
  }

  // 16-bin histogram counted with ballots: every lane ends with all counts;
  // the trip count is uniform in the warp
  template <bool QUADS, class A>
  static __device__ void hist16(const A& a, int bw, int bh, int q16, int* hist) {
    const int lw = QUADS ? a.lw - 1 : a.lw, h = QUADS ? a.h >> 1 : a.h;
    const int cw = QUADS ? bw >> 1 : bw, ch = QUADS ? bh >> 1 : bh;
  #pragma unroll
    for (int k = 0; k < 16; ++k) hist[k] = 0;
    for (int p0 = 0; p0 < (h << lw); p0 += TW) {
      const int p = p0 + lane(), r = p >> lw, c = p & ((1 << lw) - 1);
      int bin = -1;
      if (p < (h << lw) && r < ch && c < cw) {
        if (QUADS) {
          int ds = uavg4(at(a, 2 * r, 2 * c), at(a, 2 * r, 2 * c + 1),
                         at(a, 2 * r + 1, 2 * c), at(a, 2 * r + 1, 2 * c + 1));
          bin = min((ds * q16) >> 16, 15);
        } else {
          bin = min(max((at(a, r, c) * q16) >> 16, 0), 15);
        }
      }
  #pragma unroll
      for (int k = 0; k < 16; ++k) hist[k] += __popc(tile_ballot(bin == k));
    }
  }

  template <class A>
  static __device__ int feat_hvar(const A& a, int bw, int bh, int avg) {
    int hist[16];
    hist16<false>(a, bw, bh, (8 << 16) / max(avg, 1), hist);
    const int area = max(bw * bh, 1);
    int tot = 0;
  #pragma unroll
    for (int k = 0; k < 16; ++k) tot += hist[k];
    const int hm = tot / 16;
    unsigned hv = 0;
  #pragma unroll
    for (int k = 0; k < 16; ++k)
      hv += (unsigned)((hist[k] - hm) * (hist[k] - hm));
    return (int)((hv * 256u) / (unsigned)(16 * area * area));
  }

  template <class A>
  static __device__ int feat_peaks(const A& a, int bw, int bh, int avg) {
    int hist[16];
    hist16<true>(a, bw, bh, (8 << 16) / max(avg, 1), hist);
    int tot = 0, mx = 0;
  #pragma unroll
    for (int k = 0; k < 16; ++k) {
      tot += hist[k];
      mx = max(mx, hist[k]);
    }
    const int pavg = tot / 16, maxv = mx >> 2;
    int n = 0;
  #pragma unroll
    for (int k = 0; k < 16; ++k) {
      int l = k > 0 ? hist[k - 1] : -1, r = k < 15 ? hist[k + 1] : -1;
      if (hist[k] > l && hist[k] > r && (hist[k] > maxv || hist[k] > pavg)) ++n;
    }
    return n;
  }

  // the masked means of K windows of one shape, one pass
  template <int K>
  static __device__ void masked_avg_k(const Win (&a)[K], int bw, int bh,
                                      int (&out)[K]) {
    int s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0;
    FOR_CELLS(a[0].h, a[0].lw, bw, bh, r, c) {
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] += at(a[k], r, c);
    }
    wsum_k(s);
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = s[k] / max(bw * bh, 1);
  }

  // Greedy walk with retry (ref: hme.c:1300-1370), the plain version's
  // _refine_loop for one block. The five probes of a pass are scored at
  // once (a probe outside the frame on its clamped window, never used);
  // then the pass takes the first improvement in kRect order, as the
  // reference's sequential probes do.
  template <class A>
  static __device__ void refine(const G& g, const Lv& L, const A& sw, Res& r,
                                int qthresh) {
    const int level = g.level, step = 1 << level;
    int m[4] = {I32MAX, I32MAX, I32MAX, I32MAX};
    bool done = false;
    while (!done) {
      const int bx0 = r.dx, by0 = r.dy;
      const uint8_t* rp[5];
#pragma unroll
      for (int k = 0; k < 5; ++k)
        rp[k] = win(L.ref, r.bx + bx0 + kRectX[k], r.by + by0 + kRectY[k],
                    g.blk_h, g.blk_w).p;
      int raw5[5];
      hier_k(level, sw, rp, L.ref.W, r.bw, r.bh, r.ew, r.tw, r.aw, raw5);
      bool improved = false;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int tvx = bx0 + kRectX[k], tvy = by0 + kRectY[k];
        if (improved ||
            invalid_block(r.bx + tvx, r.by + tvy, r.bw, r.bh, 0, g.fw, g.fh))
          continue;
        const int raw = raw5[k];
        const int sc = wadd(raw, mv_cost(g, r.px, r.py, tvx * step * 4,
                                         tvy * step * 4, level > 1));
        if (k >= 1) m[k - 1] = raw;
        const bool ge = level == 0 && tvx == 0 && tvy == 0 && raw <= qthresh;
        const bool better = !ge && r.best > sc;
        if (ge || better) {
          r.dx = tvx;
          r.dy = tvy;
        }
        if (ge) {
          r.best = raw;
          r.good = 1;
          done = true;
        } else if (better) {
          r.best = sc;
        }
        improved = improved || better || ge;
      }
      if (improved || done) continue;
      // diagonal probe only when the 5-point pass had no improvement
      const int tvx = r.dx + (m[0] <= m[1] ? 1 : -1);
      const int tvy = r.dy + (m[2] <= m[3] ? 1 : -1);
      bool better = false;
      if (!invalid_block(r.bx + tvx, r.by + tvy, r.bw, r.bh, 0, g.fw, g.fh)) {
        const uint8_t* rp1[1] = {
            win(L.ref, r.bx + tvx, r.by + tvy, g.blk_h, g.blk_w).p};
        int raw1[1];
        hier_k(level, sw, rp1, L.ref.W, r.bw, r.bh, r.ew, r.tw, r.aw, raw1);
        const int sc = wadd(raw1[0], mv_cost(g, r.px, r.py, tvx * step * 4,
                                             tvy * step * 4, level > 1));
        better = r.best > sc;
        if (better) {
          r.dx = tvx;
          r.dy = tvy;
          r.best = sc;
        }
      }
      done = !better;
    }
  }

  // The candidates of a block's search between block_pre and block_post.
  struct Cand {
    int n, dep;            // slots; the first of the neighbour-dependent ones
    int pending;           // neighbour slots left to block_post (0 or ndep)
    bool pred;             // block_pre computed the median predictor
    int cx[26], cy[26];    // each slot's vector, scaled to the level
    bool use[26];          // usable (cok, inside the frame)
    int raw[26];           // metric of a usable slot's vector (block_pre's)
    int zos;               // the good-enough metric vs the source reference
    // an upper level's refine run before the wait (block_pre): from the
    // start (sx0, sy0; score sbest0) to (sdx, sdy; score sbest)
    bool spec;
    int sx0, sy0, sbest0, sdx, sdy, sbest;
  };
  // the neighbour-dependent slots: the scaled median predictor at level 0,
  // then the left, top and top-left vectors
  static __device__ __forceinline__ int ndep(int level) {
    return level == 0 ? 4 : 3;
  }

  // median predictor (ref: dsv.c:373-400)
  static __device__ void predictor(const G& g, const Lv& L, int i, int j,
                                   Res& r) {
    int lx = 0, ly = 0, tx = 0, ty = 0, cx = 0, cy = 0;
    if (i > 0) {
      lx = out_at(L, g, 0, i - 1, j);
      ly = out_at(L, g, 1, i - 1, j);
    }
    if (j > 0) {
      tx = out_at(L, g, 0, i, j - 1);
      ty = out_at(L, g, 1, i, j - 1);
    }
    if (i > 0 && j > 0) {
      cx = out_at(L, g, 0, i - 1, j - 1);
      cy = out_at(L, g, 1, i - 1, j - 1);
    }
    r.px = pred3(lx, tx, cx);
    r.py = pred3(ly, ty, cy);
  }

  // the neighbour-dependent slots' vectors (unscaled) and usability from
  // slot c.dep on (needs the predictor)
  static __device__ void neighbour_slots(const G& g, const Lv& L, int i,
                                         int j, const Res& r, Cand& c) {
    const int step = 1 << g.level;
    int s = c.dep;
    if (g.level == 0) {
      c.cx[s] = sar_r2(r.px);
      c.cy[s] = sar_r2(r.py);
      c.use[s++] = true;
    }
    const int sdx[3] = {-1, 0, -1}, sdy[3] = {0, -1, -1};
    for (int k = 0; k < 3; ++k) {
      const int xi = i + sdx[k] * step, yj = j + sdy[k] * step;
      const bool ok = xi >= 0 && yj >= 0;
      c.cx[s] = sar_r2(ok ? out_at(L, g, 0, xi, yj) : 0);
      c.cy[s] = sar_r2(ok ? out_at(L, g, 1, xi, yj) : 0);
      c.use[s++] = ok;
    }
  }

  // What the search of block (i, j) (ref: hme.c:1413-1630) can do before
  // this level's neighbours are done: the source window into buf (the
  // tile's kSrcBytes of shared memory; its view in sw), the psy weights,
  // and the metrics of every candidate that does not depend on the
  // neighbours, and of the good-enough test; at an upper level also the
  // refine from the best of those candidates. False when the block
  // starts outside the level's plane.
  static __device__ bool block_pre(const G& g, const Lv& L, int i, int j,
                                   uint8_t* buf, Res& r, SWin& sw, Cand& c) {
    const int level = g.level, step = 1 << level;
    const int yw = g.blk_w, yh = g.blk_h, fw = g.fw, fh = g.fh;
    r.bx = (i * yw) >> level;
    r.by = (j * yh) >> level;
    if (r.bx >= fw || r.by >= fh) return false;
    r.bw = min(max(fw - r.bx, 0), yw);
    r.bh = min(max(fh - r.by, 0), yh);
    const int bw = r.bw, bh = r.bh;
    {
      const Win w1[1] = {win(L.src, r.bx, r.by, yh, yw)};
      SWin v1[1];
      stage_k(w1, buf, v1);
      sw = v1[0];
    }
    const int gx = __ldg(L.gxy), gy = __ldg(L.gxy + 1);

    // psy weights + motion bias (ref: hme.c:1424-1481)
    r.mbias = yw * yh;
    r.var_src = r.avg_src = 0;
    r.ew = 2;
    r.tw = 1;
    r.aw = 0;
    if (level <= 1) {
      int detail, avg, tex;
      feat_detail(sw, bw, bh, detail, avg, tex);
      r.var_src = detail;
      r.avg_src = avg;
      int tvar = wadd(detail, (detail >> 10) * (detail >> 10));
      tvar = divt(wmul(wmul(8, tvar), g.quant) >> 9, max(bw * bh, 1));
      const int hvar = feat_hvar(sw, bw, bh, avg);
      const int qtex = feat_qtex(sw, bw, bh);
      const int npk = feat_peaks(sw, bw, bh, avg);
      if (tvar != 0) r.mbias = wadd(r.mbias, wmul(wmul(tvar, hvar - qtex), npk));
      r.mbias = max(r.mbias, 0) / (2 + iabs(gx) + iabs(gy));
      const bool smooth = detail <= ((8 * bw * bh * g.quant) >> 9);
      if (smooth) r.mbias = 0;
      r.ew = smooth ? 2 : 1;
      r.tw = smooth ? 1 : 2;
      r.aw = smooth ? 2 : 1;
      if (detail > 24 * bw * bh) r.aw = 0;
    }

    // candidates (ref: hme.c:1443-1528), in slot order; the neighbours'
    // slots [dep, dep + ndep) are filled by block_post
    int* cx = c.cx;
    int* cy = c.cy;
    bool* cok = c.use;
    int n = 0;
    r.lax = r.lay = 0;
    cx[n] = 0;
    cy[n] = 0;
    cok[n++] = true;
    c.dep = n;
    c.pending = 0;
    c.spec = false;
    // at an upper level the predictor reads cells no block of the level
    // writes (its blocks sit at multiples of its step): zero, final now
    c.pred = level > 0;
    if (c.pred) predictor(g, L, i, j, r);
    if (level < g.levels) {
      const int pmask = ~((step << 1) - 1);
      const int pi = i & pmask, pj = j & pmask;
      const int* PX = L.parent;
      const int* PY = L.parent + g.nbv * g.nbh;
      int pxv[9], pyv[9], dist[9];
      bool pok[9], inl[9];
      int npar = 0, sx = 0, sy = 0;
      for (int k = 0; k < 9; ++k) {
        const int x = pi + kPtsX[k] * step, y = pj + kPtsY[k] * step;
        pok[k] = x >= 0 && x < g.nbh && y >= 0 && y < g.nbv;
        pxv[k] = pok[k] ? grid_at(PX, g, x, y) : 0;
        pyv[k] = pok[k] ? grid_at(PY, g, x, y) : 0;
        npar += pok[k];
        sx = wadd(sx, pxv[k]);
        sy = wadd(sy, pyv[k]);
      }
      const int nd1 = max(npar, 1);
      const int lax0 = divt(sx, nd1), lay0 = divt(sy, nd1);
      int sd = 0;
      for (int k = 0; k < 9; ++k) {
        dist[k] = pok[k] ? wadd(wmul(pxv[k] - lax0, pxv[k] - lax0),
                                wmul(pyv[k] - lay0, pyv[k] - lay0))
                         : 0;
        sd = wadd(sd, dist[k]);
      }
      const int avgd = fdiv(sd, nd1);
      int ssd = 0;
      for (int k = 0; k < 9; ++k)
        if (pok[k]) ssd = wadd(ssd, wmul(dist[k] - avgd, dist[k] - avgd));
      const int thresh = wadd(avgd, (int)isqrt_u32((unsigned)divt(ssd, nd1)));
      int nl = 0;
      sx = sy = 0;
      for (int k = 0; k < 9; ++k) {
        inl[k] = pok[k] && dist[k] <= thresh;
        nl += inl[k];
        if (inl[k]) {
          sx = wadd(sx, pxv[k]);
          sy = wadd(sy, pyv[k]);
        }
      }
      r.lax = divt(sx, max(nl, 1));
      r.lay = divt(sy, max(nl, 1));
      cx[n] = r.lax;
      cy[n] = r.lay;
      cok[n++] = true;
      c.dep = n;
      n += ndep(level);
      c.pending = ndep(level);
      if (g.has_tmv) {
        const int* TX = L.tmv;
        const int* TY = L.tmv + g.nbv * g.nbh;
        for (int k = 0; k < 9; ++k) {
          const int x = i + kRectX[k] * step, y = j + kRectY[k] * step;
          const bool ok = x >= 0 && x < g.nbh && y >= 0 && y < g.nbv;
          cx[n] = sar_r2(ok ? grid_at(TX, g, x, y) : 0);
          cy[n] = sar_r2(ok ? grid_at(TY, g, x, y) : 0);
          cok[n++] = ok;
        }
      }
      cx[n] = gx;
      cy[n] = gy;
      cok[n++] = true;
      for (int k = 0; k < 9; ++k) {
        cx[n] = pxv[k];
        cy[n] = pyv[k];
        cok[n++] = inl[k];
      }
    }
    c.n = n;

    // scale to the level and score the usable slots' distinct vectors,
    // kCandBatch at a time; a slot's score is its vector's
    const int d1 = c.dep + c.pending;
    int ux[26], uy[26], nu = 0;
    for (int s = 0; s < n; ++s) {
      if (s == c.dep) s = d1;
      if (s >= n) break;
      const int dx = cx[s] >> level, dy = cy[s] >> level;
      cx[s] = dx;
      cy[s] = dy;
      cok[s] = cok[s] && !invalid_block(r.bx + dx, r.by + dy, bw, bh, 0, fw, fh);
      if (!cok[s]) continue;
      int u = 0;
      while (u < nu && !(ux[u] == dx && uy[u] == dy)) ++u;
      c.raw[s] = u;  // its vector's index, its score below
      if (u == nu) {
        ux[nu] = dx;
        uy[nu++] = dy;
      }
    }
    int uraw[26];
    for (int u0 = 0; u0 < nu; u0 += kCandBatch) {
      const uint8_t* rp[kCandBatch];
#pragma unroll
      for (int k = 0; k < kCandBatch; ++k) {
        const int u = min(u0 + k, nu - 1);
        rp[k] = win(L.ref, r.bx + ux[u], r.by + uy[u], yh, yw).p;
      }
      int raw[kCandBatch];
      hier_k(level, sw, rp, L.ref.W, bw, bh, r.ew, r.tw, r.aw, raw);
#pragma unroll
      for (int k = 0; k < kCandBatch; ++k)
        if (u0 + k < nu) uraw[u0 + k] = raw[k];
    }
    for (int s = 0; s < n; ++s)
      if ((s < c.dep || s >= d1) && cok[s]) c.raw[s] = uraw[c.raw[s]];
    c.zos = metr(sw, win(L.ogr, r.bx, r.by, yh, yw), bw, bh, r.ew, r.tw,
                 r.aw);

    // An upper level's scores need no neighbour (the predictor is zero),
    // so the refine from the best slot that is not a neighbour's runs
    // here; block_post keeps it when the neighbours' slots leave that
    // start the winner. Skipped when the good-enough test passes whatever
    // the winner (its threshold only grows).
    if (level > 0 && c.zos >= ((g.quant * bw * bh) >> 11)) {
      int szero;
      first_min(g, r, c, nullptr, c.sx0, c.sy0, c.sbest0, szero);
      Res rs = r;
      rs.dx = c.sx0;
      rs.dy = c.sy0;
      rs.best = c.sbest0;
      refine(g, L, sw, rs, 0);
      c.sdx = rs.dx;
      c.sdy = rs.dy;
      c.sbest = rs.best;
      c.spec = true;
    }
    return true;
  }

  // The first strict minimum over the slots, value-equal duplicates of an
  // earlier usable slot skipped (ref: hme.c:1522-1566): the winner's
  // vector (bdx, bdy) and score, and slot 0's raw metric. dscore: the
  // neighbours' slots' metrics, or null to leave those slots out.
  static __device__ void first_min(const G& g, const Res& r, const Cand& c,
                                   const int* dscore, int& bdx, int& bdy,
                                   int& best_score, int& score_zero) {
    const int level = g.level, step = 1 << level;
    int ux[26], uy[26], nu = 0;
    best_score = I32MAX;
    bdx = bdy = 0;
    score_zero = I32MAX;
    for (int s = 0; s < c.n; ++s) {
      const bool dep = s >= c.dep && s < c.dep + c.pending;
      if ((dep && dscore == nullptr) || !c.use[s]) continue;
      const int dx = c.cx[s], dy = c.cy[s];
      bool dup = false;
      for (int t = 0; t < nu; ++t) dup = dup || (ux[t] == dx && uy[t] == dy);
      if (dup) continue;
      ux[nu] = dx;
      uy[nu++] = dy;
      const int raw = dep ? dscore[s - c.dep] : c.raw[s];
      if (s == 0) score_zero = raw;
      int sc = wadd(raw, mv_cost(g, r.px, r.py, dx * step * 4, dy * step * 4,
                                 level > 1));
      if (dx == r.lax && dy == r.lay) sc = max(sc - (r.mbias >> level), 0);
      if (sc < best_score) {
        best_score = sc;
        bdx = dx;
        bdy = dy;
      }
    }
  }

  // The rest of the search of block (i, j), once its left, top and
  // top-left neighbours of this level are in the grids: the median
  // predictor, the neighbours' candidates, the first strict minimum over
  // the slots with value-equal duplicates of an earlier usable slot
  // skipped (ref: hme.c:1522-1566), the good-enough test and the refine.
  static __device__ void block_post(const G& g, const Lv& L, int i, int j,
                                    const SWin& sw, Res& r, Cand& c) {
    const int level = g.level;
    const int yw = g.blk_w, yh = g.blk_h, fw = g.fw, fh = g.fh;
    const int bw = r.bw, bh = r.bh;

    // the neighbours' slots, scored in one pass
    int dscore[4] = {I32MAX, I32MAX, I32MAX, I32MAX};
    if (!c.pred) predictor(g, L, i, j, r);
    if (c.pending) {
      neighbour_slots(g, L, i, j, r, c);
      const uint8_t* rp[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = c.dep + min(k, ndep(level) - 1);
        const int dx = c.cx[t] >> level, dy = c.cy[t] >> level;
        if (k < ndep(level)) {
          c.cx[t] = dx;
          c.cy[t] = dy;
          c.use[t] = c.use[t] &&
                     !invalid_block(r.bx + dx, r.by + dy, bw, bh, 0, fw, fh);
        }
        rp[k] = win(L.ref, r.bx + c.cx[t], r.by + c.cy[t], yh, yw).p;
      }
      hier_k(level, sw, rp, L.ref.W, bw, bh, r.ew, r.tw, r.aw, dscore);
    }

    int best_score, bdx, bdy, score_zero;
    first_min(g, r, c, dscore, bdx, bdy, best_score, score_zero);

    // good-enough vs the source reference (ref: hme.c:1569-1584)
    int qthresh = (g.quant * bw * bh) >> 11;
    if (iabs(bdx) <= 1 && iabs(bdy) <= 1) qthresh *= 2;
    r.good = 0;
    if (c.zos < qthresh) {
      r.dx = r.dy = 0;
      r.best = level == 0 ? score_zero : 0;
      r.good = 1;
      return;
    }
    if (c.spec && bdx == c.sx0 && bdy == c.sy0 && best_score == c.sbest0) {
      r.dx = c.sdx;  // block_pre's refine started where this one would
      r.dy = c.sdy;
      r.best = c.sbest;
      return;
    }
    r.dx = bdx;
    r.dy = bdy;
    r.best = best_score;
    refine(g, L, sw, r, qthresh);
  }

  // The half-pel grid (34 x 34, a zero row/column past it) of a 21x21
  // window whose (1, 1) sample is the probe origin, into the tile's shared
  // slice hg (ref: hme.c:787-815). The quarter-pel samples are derived from
  // it when read (qv). The window is staged in wbuf first, all its loads
  // issued before any is stored.
  static __device__ void hpel_grid(const Plane& pl, int x, int y, uint8_t* hg,
                                   uint8_t* wbuf) {
    const int y0 = min(max(y + BRD, 0), pl.H - 21);
    const int x0 = min(max(x + BRD, 0), pl.W - 21);
    const uint8_t* p = pl.p + (size_t)y0 * pl.W + x0;
    constexpr int kN = 21 * 21, kPer = (kN + TW - 1) / TW;
    int v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = min(u * TW + lane(), kN - 1);
      v[u] = __ldg(p + (size_t)(q / 21) * pl.W + q % 21);
    }
    tile_sync();  // every lane is done reading the previous grid and window
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = u * TW + lane();
      if (q < kN) wbuf[q] = (uint8_t)v[u];
    }
    tile_sync();
    auto px = [&](int r, int c) { return (int)wbuf[r * 21 + c]; };
    auto hb = [&](int r, int i) {
      return 5 * (px(r, i + 1) + px(r, i + 2)) - (px(r, i) + px(r, i + 3));
    };
    for (int q = lane(); q < SPD * SPD; q += TW) {
      const int j = q / SPD, i = q % SPD;
      const int r1 = px(j + 1, i + 1);
      const int hh = (5 * (r1 + px(j + 1, i + 2)) -
                      (px(j + 1, i) + px(j + 1, i + 3)) + 4) >> 3;
      const int vv = (5 * (r1 + px(j + 2, i + 1)) -
                      (px(j, i + 1) + px(j + 3, i + 1)) + 4) >> 3;
      const int dg = (5 * (hb(j + 1, i) + hb(j + 2, i)) -
                      (hb(j, i) + hb(j + 3, i)) + 32) >> 6;
      hg[(2 * j) * HGS + 2 * i] = (uint8_t)r1;
      hg[(2 * j) * HGS + 2 * i + 1] = (uint8_t)min(max(hh, 0), 255);
      hg[(2 * j + 1) * HGS + 2 * i] = (uint8_t)min(max(vv, 0), 255);
      hg[(2 * j + 1) * HGS + 2 * i + 1] = (uint8_t)min(max(dg, 0), 255);
    }
    for (int k = lane(); k < 2 * HGS - 1; k += TW) {
      if (k < HGS) hg[(HGS - 1) * HGS + k] = 0;
      else hg[(k - HGS) * HGS + HGS - 1] = 0;
    }
    tile_sync();
  }

  // (ref: hme.c:244-269): srcsp vs q[4 + t1::4, 4 + t0::4], for the 7
  // subpel probes (t0[k], t1[k]) in one pass
  static __device__ void qpsad7(const Win& a, const uint8_t* hg, const int (&t0)[7],
                                const int (&t1)[7], int ew, int tw, int aw,
                                int (&out)[7]) {
    unsigned acc[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) acc[k] = 0;
    for (int q = lane(); q < 64; q += TW) {
      const int j = q >> 3, i = q & 7;
      const Quad qa = quad_at(a, j, i);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int y = 4 + t1[k] + 8 * j, x = 4 + t0[k] + 8 * i;
        acc[k] += quad_metr(qa, qv(hg, y, x), qv(hg, y, x + 4),
                            qv(hg, y + 4, x), qv(hg, y + 4, x + 4), ew, tw, aw);
      }
    }
    wsum_k(acc);
#pragma unroll
    for (int k = 0; k < 7; ++k) out[k] = metric_return(acc[k], 16, 16);
  }

  // The probes of a subpel refine around full-pel (fpx, fpy) (ref:
  // hme.c:1051-1164), which need no neighbour: the four neighbour windows
  // staged in stage and their sse scored in one pass, the direction pick,
  // and the seven quarter-pel probes scored in one pass.
  struct Sub {
    int t0[7], t1[7], qps[7];
  };
  static __device__ void subpel_probe(const G& g, const Lv& L, const Res& r,
                                      const SWin& sw, int fpx, int fpy,
                                      uint8_t* hg, uint8_t* stage, Sub& sp) {
    const int bx = r.bx, by = r.by, bw = r.bw, bh = r.bh;
    const Win w4[4] = {win(L.ref, bx + fpx + 1, by + fpy, g.blk_h, g.blk_w),
                       win(L.ref, bx + fpx - 1, by + fpy, g.blk_h, g.blk_w),
                       win(L.ref, bx + fpx, by + fpy + 1, g.blk_h, g.blk_w),
                       win(L.ref, bx + fpx, by + fpy - 1, g.blk_h, g.blk_w)};
    SWin s4[4];
    stage_k(w4, stage, s4);
    const uint8_t* rp[4] = {s4[0].p, s4[1].p, s4[2].p, s4[3].p};
    int quad[4];
    sse_k<true>(sw, rp, s4[0].s, bw, bh, quad);
    const int xx = bx + ((bw >> 1) - 8), yy = by + ((bh >> 1) - 8);
    hpel_grid(L.ref, xx + fpx - 2, yy + fpy - 2, hg, stage);
    // primary/secondary direction pick (ref: hme.c:1108-1133)
    int prix = 0, priy = quad[3] >= quad[2] ? 1 : -1;
    int secx = quad[1] >= quad[0] ? 1 : -1, secy = 0;
    const int ms1 = quad[1] >= quad[0] ? quad[0] : quad[1];
    const int ms2 = quad[3] >= quad[2] ? quad[2] : quad[3];
    if (ms2 > ms1) {
      int t = prix; prix = secx; secx = t;
      t = priy; priy = secy; secy = t;
    }
    const int dgx = prix + secx, dgy = priy + secy;
    const int t0s[7] = {2 * prix, prix, 2 * secx, secx, 2 * dgx, dgx, prix + dgx};
    const int t1s[7] = {2 * priy, priy, 2 * secy, secy, 2 * dgy, dgy, priy + dgy};
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      sp.t0[k] = t0s[k];
      sp.t1[k] = t1s[k];
    }
    qpsad7(win(L.src, xx, yy, 16, 16), hg, t0s, t1s, r.ew, r.tw, r.aw, sp.qps);
  }

  // The rest of that subpel refine, once the median predictor (px, py) is
  // known: the probes' scores with their vector cost and the picks
  static __device__ void subpel_pick(const G& g, const Res& r, int fpx,
                                     int fpy, int best_fp, const Sub& sp,
                                     int& ret, int& sx, int& sy) {
    sx = sy = 0;
    if (best_fp == 0) {
      ret = best_fp;
      return;
    }
    const int yarea = r.bw * r.bh;
    const int area_ratio = (8 * 16 * 16) / max(yarea, 1);
    const int iarea_ratio = (8 * yarea) / (16 * 16);
    int best = (int)(((unsigned)best_fp * (unsigned)area_ratio) >> 3);
    int msc = I32MAX, mt0 = 0, mt1 = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int t0 = sp.t0[k], t1 = sp.t1[k];
      if (g.effort < 8 && ((t0 | t1) & 1)) continue;  // half-pel only
      const int sc = wadd(sp.qps[k], mv_cost(g, r.px, r.py, fpx * 4 + t0,
                                             fpy * 4 + t1, 0));
      if (sc < msc) {
        msc = sc;
        mt0 = t0;
        mt1 = t1;
      }
    }
    if (msc < best) {
      sx = mt0;
      sy = mt1;
    }
    best = min(best, msc);
    ret = (int)(((unsigned)best * (unsigned)iarea_ratio) >> 3);
  }

  // one plane of yuv_max_subblock_err (ref: hme.c:369-409): the four
  // quadrants' quad metrics in one pass over all their quads
  static __device__ unsigned max_sub(const Plane& pa, const Plane& pb, int x0, int y0,
                                     int rx, int ry, int qw, int qh, int bw2, int bh2,
                                     const Res& r) {
    const Win a0 = win(pa, x0, y0, qh, qw), a1 = win(pa, x0 + bw2, y0, qh, qw),
              a2 = win(pa, x0, y0 + bh2, qh, qw),
              a3 = win(pa, x0 + bw2, y0 + bh2, qh, qw);
    const Win b0 = win(pb, rx, ry, qh, qw), b1 = win(pb, rx + bw2, ry, qh, qw),
              b2 = win(pb, rx, ry + bh2, qh, qw),
              b3 = win(pb, rx + bw2, ry + bh2, qh, qw);
    const int lw = a0.lw - 1, ln = lw + __ffs(qh >> 1) - 1;  // log2 quads
    unsigned acc[4] = {0, 0, 0, 0};
    for (int p = lane(); p < (4 << ln); p += TW) {
      const int k = p >> ln, j = (p >> lw) & ((qh >> 1) - 1),
                i = p & ((1 << lw) - 1);
      if (j >= (bh2 >> 1) || i >= (bw2 >> 1)) continue;
      const Win a{k == 0 ? a0.p : k == 1 ? a1.p : k == 2 ? a2.p : a3.p, a0.s,
                  qh, a0.lw};
      const Win b{k == 0 ? b0.p : k == 1 ? b1.p : k == 2 ? b2.p : b3.p, b0.s,
                  qh, b0.lw};
      const unsigned v = quad_metr(quad_at(a, j, i), at(b, 2 * j, 2 * i),
                                   at(b, 2 * j, 2 * i + 1), at(b, 2 * j + 1, 2 * i),
                                   at(b, 2 * j + 1, 2 * i + 1), r.ew, r.tw, r.aw);
      acc[0] += k == 0 ? v : 0;
      acc[1] += k == 1 ? v : 0;
      acc[2] += k == 2 ? v : 0;
      acc[3] += k == 3 ? v : 0;
    }
    wsum_k(acc);
    return max(max(acc[0], acc[1]), max(acc[2], acc[3]));
  }

  // err_intra with psy (0, 1, 2) (ref: hme.c:839-889) of the four
  // subblocks k (source a[k], reference b[k], means avg_sb[k] and
  // avg_src[k]) in one pass
  template <class A>
  static __device__ void err_intra4(const A (&a)[4], const A (&b)[4], int bw,
                                    int bh, const int (&avg_sb)[4],
                                    const int (&avg_src)[4], unsigned ratio,
                                    unsigned (&isb)[4], unsigned (&isrc)[4],
                                    unsigned (&inter)[4]) {
    unsigned s[12];  // per subblock: isb, isrc, inter
#pragma unroll
    for (int k = 0; k < 12; ++k) s[k] = 0;
    FOR_CELLS(a[0].h >> 1, a[0].lw - 1, bw >> 1, bh >> 1, j, i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Quad q = quad_at(a[k], j, i);
        const int a1 = q.a1, a2 = q.a2, a3 = q.a3, a4 = q.a4, s0 = q.s0;
        const int ta = q.ta, sb = avg_sb[k], sr = avg_src[k];
        int b1 = at(b[k], 2 * j, 2 * i), b2 = at(b[k], 2 * j, 2 * i + 1);
        int b3 = at(b[k], 2 * j + 1, 2 * i), b4 = at(b[k], 2 * j + 1, 2 * i + 1);
        int s1 = uavg4(b1, b2, b3, b4);
        int tb = uavg4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4),
                       iabs(b4 - b1));
        int ae = uavg4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3),
                       iabs(a4 - b4));
        s[3 * k + 2] += ((unsigned)(ae * ae) * ratio) >> 5;
        s[3 * k + 2] += (unsigned)((ta - tb) * (ta - tb)) << 1;
        s[3 * k + 2] += (unsigned)((s0 - s1) * (s0 - s1)) << 2;
        ae = uavg4(iabs(a1 - sb), iabs(a2 - sb), iabs(a3 - sb), iabs(a4 - sb));
        s[3 * k] += (unsigned)(ae * ae) + ((unsigned)(ta * ta) << 1) +
                    ((unsigned)((s0 - sb) * (s0 - sb)) << 3);
        ae = uavg4(iabs(a1 - sr), iabs(a2 - sr), iabs(a3 - sr), iabs(a4 - sr));
        s[3 * k + 1] += (unsigned)(ae * ae) + ((unsigned)(ta * ta) << 1) +
                        ((unsigned)((s0 - sr) * (s0 - sr)) << 3);
      }
    }
    wsum_k(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      isb[k] = s[3 * k];
      isrc[k] = s[3 * k + 1];
      inter[k] = (s[3 * k + 2] * ratio) >> 5;
    }
  }

  template <class A, class B>
  static __device__ void eprm_clips(const A& s, const B& rf, int bw, int bh,
                                    int avg_src, int avg_ref, bool& ci, bool& cd,
                                    bool& cr) {
    ci = cd = cr = false;
    FOR_CELLS(s.h, s.lw, bw, bh, r, c) {
      const int v = at(s, r, c);
      cr = cr || ((((v - at(rf, r, c)) + 128) & ~0xFF) != 0);
      ci = ci || (((v - (avg_ref - 128)) & ~0xFF) != 0);
      cd = cd || (((v - (avg_src - 128)) & ~0xFF) != 0);
    }
    ci = tile_any(ci);
    cd = tile_any(cd);
    cr = tile_any(cr);
  }

  // The base level of one block: search + subpel + mode decisions + intra
  // tests + flags (ref: hme.c:1598-1833; plain: hme_wave.level0_block).
  // What needs no neighbour of this level (block_pre, the probes of the
  // first subpel refine, at the parents' vector) runs before wait(), which
  // returns once the left, top and top-left blocks are in the grids. Lane
  // 0 writes the block's grid entries; every lane adds its stats to st[4]
  // (identical in the tile). smem: the tile's kTileBytes.
  template <class Wait>
  static __device__ void level0_block(const G& g, const Lv& L, int i, int j,
                                      uint8_t* smem, int* st, Wait&& wait) {
    uint8_t* hg = smem;
    uint8_t* stage = smem + kHgBytes + kSrcBytes;
    Res r;
    SWin sw;
    Cand c;
    Sub s1;
    const bool in = block_pre(g, L, i, j, smem + kHgBytes, r, sw, c);
    const bool cond1 = in && g.effort >= 4 &&
                       !invalid_block(r.bx + r.lax, r.by + r.lay, r.bw, r.bh,
                                      4, g.fw, g.fh);
    if (cond1) subpel_probe(g, L, r, sw, r.lax, r.lay, hg, stage, s1);
    wait();
    if (!in) return;
    block_post(g, L, i, j, sw, r, c);
    const int yw = g.blk_w, yh = g.blk_h, fw = g.fw, fh = g.fh;
    const int bx = r.bx, by = r.by, bw = r.bw, bh = r.bh;
    const int yarea = bw * bh, area1 = max(yarea, 1);
    const int skipt = (g.quant * g.quant) >> 19;
    int best = (r.dx == r.lax && r.dy == r.lay) ? wadd(r.best, r.mbias) : r.best;
    const int best_fp = best;
    int sub_x = 0, sub_y = 0, fpelx = r.dx, fpely = r.dy;
    if (g.effort >= 4) {
      int ret1 = 0, sx1 = 0, sy1 = 0;
      if (cond1) {
        subpel_pick(g, r, r.lax, r.lay, best_fp, s1, ret1, sx1, sy1);
        best = ret1;
      }
      const bool found1 = cond1 && (sx1 != 0 || sy1 != 0);
      const bool cond2 = !found1 && !r.good &&
                         !invalid_block(bx + r.dx, by + r.dy, bw, bh, 4, fw, fh);
      if (cond2) {
        int ret2, sx2, sy2;
        Sub s2;
        subpel_probe(g, L, r, sw, r.dx, r.dy, hg, stage, s2);
        subpel_pick(g, r, r.dx, r.dy, best_fp, s2, ret2, sx2, sy2);
        best = ret2;
        sub_x = sx2;
        sub_y = sy2;
      } else if (found1) {
        sub_x = sx1;
        sub_y = sy1;
      }
      if (found1) {
        fpelx = r.lax;
        fpely = r.lay;
      }
    }
    const int mvx = fpelx * 4 + sub_x, mvy = fpely * 4 + sub_y;

    // block metrics vs the refs (ref: hme.c:1636-1692)
    const bool is_subpel = ((mvx | mvy) & 3) != 0;
    const int ratio =
        is_subpel ? (int)(((unsigned)best << 5) / (unsigned)max(best_fp, 1)) : 32;
    const unsigned ratio_u = (unsigned)ratio;
    SWin rfw;  // the reference block, staged
    {
      const Win w1[1] = {win(L.ref, bx + fpelx, by + fpely, yh, yw)};
      SWin v1[1];
      stage_k(w1, stage, v1);
      rfw = v1[0];
    }
    const int ogrerr = metr(sw, win(L.ogr, bx + fpelx, by + fpely, yh, yw), bw,
                            bh, r.ew, r.tw, r.aw);
    int ogrmad = fdiv(wadd(ogrerr, area1 / 2), area1);
    ogrmad = (int)(((unsigned)ogrmad * ratio_u) >> 5);
    const int mad = fdiv(wadd(best, area1 / 2), area1);
    int var_ref, avg_ref, tex_ref;
    feat_detail(rfw, bw, bh, var_ref, avg_ref, tex_ref);
    const int var_src = r.var_src, avg_src = r.avg_src;
    int dv = min(ratio, 32);
    const int ipolvar = wadd(wmul(var_src, dv), wmul(var_ref, 32 - dv)) >> 5;
    dv = iabs(var_src - ipolvar);
    const bool maintain = var_src > 16 * yarea && var_src < 32 * yarea;

    const int cbx = i * (yw >> g.hs), cby = j * (yh >> g.vs);
    const int cbmx = cbx + (fpelx >> g.hs), cbmy = cby + (fpely >> g.vs);
    const int cbw = bw >> g.hs, cbh = bh >> g.vs;
    const int cw_max = yw >> g.hs, ch_max = yh >> g.vs;
    const int chroma_ratio = ((cbw * cbh) << 4) / area1;
    int cavg[4];  // src u, src v, ref u, ref v
    {
      const Win cw4[4] = {win(L.su, cbx, cby, ch_max, cw_max),
                          win(L.sv, cbx, cby, ch_max, cw_max),
                          win(L.ru, cbmx, cbmy, ch_max, cw_max),
                          win(L.rv, cbmx, cbmy, ch_max, cw_max)};
      masked_avg_k(cw4, cbw, cbh, cavg);
    }
    const int uavg_src = cavg[0], vavg_src = cavg[1];
    const int uavg_ref = cavg[2], vavg_ref = cavg[3];
    const bool greyish = iabs(uavg_src - 128) < 8 && iabs(vavg_src - 128) < 8;
    const int avg_y_dif = iabs(avg_src - avg_ref);
    const int avg_c_dif =
        (iabs(uavg_src - uavg_ref) + iabs(vavg_src - vavg_ref) + 1) >> 1;
    bool eprmi, eprmd, eprmr;
    eprm_clips(sw, rfw, bw, bh, avg_src, avg_ref, eprmi, eprmd, eprmr);
    const int limx = (g.nbh - 1) * yw - 1, limy = (g.nbv - 1) * yh - 1;
    const int oobx = i * yw + (mvx >> 2), ooby = j * yh + (mvy >> 2);
    const bool oob = oobx < 0 || ooby < 0 || oobx >= limx || ooby >= limy;
    // neighbordif with this block's vector (ref: dsv.c:402-438)
    int nd[2];
    for (int k = 0; k < 2; ++k) {
      const int xi = k ? i : i - 1, yj = k ? j - 1 : j;
      const bool ok = k ? j > 0 : i > 0;
      int vx = mvx, vy = mvy;
      if (ok) {
        const int nx = out_at(L, g, 0, xi, yj), ny = out_at(L, g, 1, xi, yj);
        if ((nx != 0 || ny != 0) && out_at(L, g, 6, xi, yj) == 0) {
          vx = nx;
          vy = ny;
        }
      }
      nd[k] = iabs(vx - mvx) + iabs(vy - mvy);
    }
    const bool small = iabs(mvx) < 2 && iabs(mvy) < 2;
    const int neidif = small ? 0 : (nd[0] + nd[1]) / 3;

    // skip test (ref: hme.c:1694-1729)
    bool skip = false;
    if (!(g.skip_neg || g.lossless) && (r.good || (mvx == 0 && mvy == 0))) {
      unsigned sth = (unsigned)skipt * (unsigned)yarea + 4u * (unsigned)var_src +
                     (unsigned)yarea * (unsigned)g.skip_thresh;
      if (g.quant < (1 << 10)) sth = (sth * (unsigned)g.quant) >> 10;
      if (avg_y_dif <= 2) sth = max(sth, (unsigned)(3 * (yarea + var_src)));
      sth = max(sth, (unsigned)yarea);
      if (r.good) sth *= 2u;
      const unsigned z0 = max_sub(L.src, L.ref, bx, by, bx, by, yw / 2, yh / 2,
                                  bw / 2, bh / 2, r);
      const unsigned z1 = max_sub(L.su, L.ru, cbx, cby, cbx, cby, cw_max / 2,
                                  ch_max / 2, cbw / 2, cbh / 2, r);
      const unsigned z2 = max_sub(L.sv, L.rv, cbx, cby, cbx, cby, cw_max / 2,
                                  ch_max / 2, cbw / 2, cbh / 2, r);
      const unsigned cth =
          ((unsigned)chroma_ratio * sth * (unsigned)max(skipt, 1)) >> 5;
      const int dy_ = avg_src - avg_ref;
      const unsigned z0s = ((z0 * ratio_u) >> 5) + (unsigned)wmul(wmul(dy_, dy_), yarea);
      skip = z0s <= sth && ((z1 * ratio_u) >> 5) <= cth &&
             ((z2 * ratio_u) >> 5) <= cth;
    }

    // no-residual decisions (ref: hme.c:1731-1777)
    bool noxy = false, noxc = false, simc = false;
    if (!g.lossless) {
      const bool y_pre = avg_y_dif <= 2;
      bool c_pre = !greyish && avg_c_dif <= 2;
      if (!oob && (y_pre || c_pre)) {
        const int carea = 4 * cbw * cbh;
        const unsigned b0 = max_sub(L.src, L.ref, bx, by, bx + fpelx, by + fpely,
                                    yw / 2, yh / 2, bw / 2, bh / 2, r);
        const unsigned b1 = max_sub(L.su, L.ru, cbx, cby, cbmx, cbmy, cw_max / 2,
                                    ch_max / 2, cbw / 2, cbh / 2, r);
        const unsigned b2 = max_sub(L.sv, L.rv, cbx, cby, cbmx, cbmy, cw_max / 2,
                                    ch_max / 2, cbw / 2, cbh / 2, r);
        int xth = (int)((unsigned)(skipt * yarea) + (unsigned)ipolvar);
        xth = max(wadd(xth, -wmul(wmul(yarea, neidif), 2)), 0);
        xth = (int)(((unsigned)xth * (unsigned)g.quant) >> 12);
        xth = min(max(xth, 32), yarea * 4);
        const Win uv[2] = {win(L.su, cbx, cby, ch_max, cw_max),
                           win(L.sv, cbx, cby, ch_max, cw_max)};
        int d_[2], a_[2], tex[2];  // only the textures: no second pass
        feat_detail_k<2, false>(uv, cbw, cbh, d_, a_, tex);
        c_pre = c_pre && (tex[0] > carea || tex[1] > carea);
        const int xthc = (chroma_ratio * xth) >> 4;
        noxy = y_pre && ((b0 * ratio_u) >> 5) < (unsigned)(4 * xth);
        noxc = c_pre && ((b1 * ratio_u) >> 5) < (unsigned)xthc &&
               ((b2 * ratio_u) >> 5) < (unsigned)xthc;
      }
      simc = !oob && dv < fdiv(var_src, 4);
    }

    // luma intra subblock test (ref: hme.c:891-985)
    int rmx = mvx, rmy = mvy;
    if (g.has_tmv) {
      rmx = grid_at(L.tmv, g, i, j);
      rmy = grid_at(L.tmv + g.nbv * g.nbh, g, i, j);
    }
    int submask = 0, dcv = 0;
    {
      const int sbw = bw / 2, sbh = bh / 2, qw = yw / 2, qh = yh / 2;
      const bool skip_all = ((mvx != 0 || mvy != 0) && neidif < 3 &&
                             iabs(rmx - mvx) < 3 && iabs(rmy - mvy) < 3) ||
                            sbw == 0 || sbh == 0;
      int detail_src = wadd(ipolvar, fdiv(ipolvar, max(neidif, 1)));
      int avg_tot = 0, nsub = 0;
      unsigned err_sub = 0, err_src = 0;
      // every subblock's features and errors at once (none depends on the
      // decisions), then the reference's loop over them
      SWin md[4], sd[4];
      int det[8], av[8], t_[8], dc[4];
      unsigned esub[4], esrc[4], einter[4];
      if (!skip_all) {
        Win w8[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int f = k & 1, gq = k >> 1;
          w8[k] = win(L.ref, bx + fpelx + f * sbw, by + fpely + gq * sbh, qh,
                      qw);
          w8[4 + k] = win(L.src, bx + f * sbw, by + gq * sbh, qh, qw);
        }
        SWin v8[8];
        stage_k<8, 2>(w8, stage, v8);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          md[k] = v8[k];
          sd[k] = v8[4 + k];
        }
        feat_detail_k(v8, sbw, sbh, det, av, t_);
#pragma unroll
        for (int k = 0; k < 4; ++k) dc[k] = (av[4 + k] + avg_src * 3 + 2) >> 2;
        const int avg_sub4[4] = {av[0], av[1], av[2], av[3]};
        err_intra4(sd, md, sbw, sbh, avg_sub4, dc, ratio_u, esub, esrc, einter);
      }
      for (int k = 0; k < 4 && !skip_all; ++k) {
        const int avg_sub = av[k], local_detail = det[4 + k];
        const int avg_local = av[4 + k];
        const int dcd = iabs(avg_local - avg_sub) + 2;
        if ((unsigned)local_detail >
            (((unsigned)wmul(wmul(dcd, dcd), yarea) * ratio_u) >> 5))
          continue;
        const unsigned se_sub = esub[k], se_src = esrc[k], inter = einter[k];
        const int lo = wadd(wadd(detail_src, local_detail), 1) >> 1;
        const int lerp =
            wadd(wmul(lo, 32 - g.psyf), wmul(detail_src, g.psyf)) >> 5;
        const unsigned ld2 = (unsigned)max(lerp, lo);
        if (se_sub + ld2 < inter || se_src + ld2 < inter) {
          submask |= 1 << k;
          err_src += se_src;
          err_sub += se_sub;
          avg_tot += se_sub < se_src ? avg_sub : dc[k];
          ++nsub;
          detail_src = fdiv(wmul(detail_src, 4), 5);
        }
      }
      if (submask != 0 && err_src < err_sub)
        dcv = fdiv(avg_tot, max(nsub, 1)) | SRC_DC_PRED;
    }
    // chroma intra subblock test (ref: hme.c:987-1048)
    if (g.effort >= 6) {
      const int dsc = fdiv(ipolvar, max(bw * bh, 1));
      const int sbw = cbw / 2, sbh = cbh / 2, qw = cw_max / 2, qh = ch_max / 2;
      const int thr = submask != 0 ? dsc : wmul(dsc, dsc);
      const bool blocked = sbw == 0 || sbh == 0 || (unsigned)mad <= (unsigned)thr ||
                           (unsigned)thr > 64u || (iabs(mvx) < 4 && iabs(mvy) < 4);
      if (!blocked) {
        const int ramp = wmul(avg_src, avg_src) >> 8;
        // the means of every subblock's four planes in one pass
        Win w16[16];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int f = k & 1, gq = k >> 1;
          w16[4 * k] = win(L.su, cbx + f * sbw, cby + gq * sbh, qh, qw);
          w16[4 * k + 1] = win(L.sv, cbx + f * sbw, cby + gq * sbh, qh, qw);
          w16[4 * k + 2] = win(L.ru, cbmx + f * sbw, cbmy + gq * sbh, qh, qw);
          w16[4 * k + 3] = win(L.rv, cbmx + f * sbw, cbmy + gq * sbh, qh, qw);
        }
        int av[16];  // per subblock: us, vs, ur, vr
        masked_avg_k(w16, sbw, sbh, av);
        int add = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (submask & (1 << k)) continue;
          const int* a = av + 4 * k;
          const int dif = wmul(wadd(wmul(a[0] - a[2], a[0] - a[2]),
                                    wmul(a[1] - a[3], a[1] - a[3])),
                               ramp) >> 8;
          if ((unsigned)dif > (unsigned)thr) add += 1 << k;
        }
        submask |= add;
      }
    }
    bool intra = submask != 0;

    // EPRM merge, skip override, flags (ref: hme.c:1722-1728, 1801-1820)
    bool m_intra = (dcv & SRC_DC_PRED) ? eprmd : eprmi;
    m_intra = m_intra || (submask != MASK_ALL_INTRA && eprmr);
    const bool m_inter = eprmr || (submask != 0 && eprmi);
    bool eprm = intra ? m_intra : m_inter;
    int omx = intra ? fpelx * 4 : mvx, omy = intra ? fpely * 4 : mvy;
    simc = simc && !(intra || eprm);
    if (skip) {
      omx = omy = 0;
      intra = eprm = simc = noxy = noxc = false;
    }
    const int err = (skip || noxy) ? 0 : (mad & 0xFFFF);
    const int flags = (int)intra | ((int)eprm << 1) | ((int)maintain << 2) |
                      ((int)skip << 3) | ((int)noxy << 5) | ((int)noxc << 6) |
                      ((int)simc << 7);
    if (lane() == 0) {
      const int n = g.nbv * g.nbh, idx = j * g.nbh + i;
      int* o = L.out;
      o[idx] = omx;
      o[n + idx] = omy;
      o[2 * n + idx] = flags;
      o[3 * n + idx] = err;
      o[4 * n + idx] = dcv;
      o[5 * n + idx] = submask;
      o[6 * n + idx] = skip;
    }
    // stats (ref: hme.c:1789-1799, 1825-1831)
    if (!skip && !noxy) st[0] = wadd(st[0], mad);
    if (!skip) st[1] += (ogrmad > 11) + (avg_c_dif >= 32);
    st[2] += best > 0;
    st[3] += intra;
  }

};

// One upper level (kernels 4/6): the ca x cb blocks of the level (every
// stream lane's, under kernel 6) through run_dag, on the tiles of every CTA
// of the launch; DAG node (a, b) is block (a * step, b * step), whose
// neighbours' fields (i - step, j), (i, j - step) and (i - step, j - step)
// are nodes (a - 1, b), (a, b - 1) and (a - 1, b - 1). Each block's search
// is split around the wait for them as at the base level: block_pre, then
// wait(), then block_post and lane 0's writes of fx * step, fy * step; a
// block that starts outside the level's plane writes nothing (its fields
// stay the caller's zeros) and is still published. lane_of(ln, g, L) sets
// the geometry and planes of stream lane ln. smem: kUpperTileBytes per
// tile.
template <int TW, class LaneOf>
__device__ void upper_dag(const Dag& dag, uint8_t* smem, LaneOf lane_of) {
  using T = Tile<TW>;
  uint8_t* buf = smem + (threadIdx.x / TW) * kUpperTileBytes;
  G g;
  Lv L;
  int cur = -1;
  run_dag<T>(dag, [&](int ln, int a, int b, auto&& wait) {
    if (ln != cur) {
      lane_of(ln, g, L);
      cur = ln;
    }
    const int step = 1 << g.level, i = a * step, j = b * step;
    Res r;
    SWin sw;
    typename T::Cand c;
    const bool in = T::block_pre(g, L, i, j, buf, r, sw, c);
    wait();
    if (!in) return;
    T::block_post(g, L, i, j, sw, r, c);
    if (T::lane() == 0) {
      L.out[j * g.nbh + i] = r.dx * step;
      L.out[g.nbv * g.nbh + j * g.nbh + i] = r.dy * step;
    }
  });
}

// the DAG of an upper level of `lanes` stream lanes: its ca x cb blocks
// and the scheduler's scratch
inline Dag upper_dag_of(const G& g, int lanes, int* sched) {
  const int step = 1 << g.level;
  return Dag{(g.nbh + step - 1) / step, (g.nbv + step - 1) / step, lanes,
             sched, sched + 1};
}

// The base level (kernels 5/7): every block of the DAG's stream lanes
// through run_dag, on the tiles of every CTA of the launch.
// lane_of(ln, g, L, sums) sets the geometry, planes and frame-sum pointer
// (4,) of stream lane ln; the frame sums a tile gathers are added with
// atomics when its lane changes and at the end (a sum of wrapping int32:
// its value does not depend on the order). smem: kTileBytes per tile.
template <int TW, class LaneOf>
__device__ void level0_dag(const Dag& dag, uint8_t* smem, LaneOf lane_of) {
  using T = Tile<TW>;
  uint8_t* mine = smem + (threadIdx.x / TW) * kTileBytes;
  G g;
  Lv L;
  int* sums = nullptr;
  int cur = -1, st[4] = {0, 0, 0, 0};
  auto flush = [&]() {
    if (sums != nullptr && T::lane() == 0)
      for (int k = 0; k < 4; ++k) atomicAdd(sums + k, st[k]);
    for (int k = 0; k < 4; ++k) st[k] = 0;
  };
  run_dag<T>(dag, [&](int ln, int i, int j, auto&& wait) {
    if (ln != cur) {
      flush();
      lane_of(ln, g, L, sums);
      cur = ln;
    }
    T::level0_block(g, L, i, j, mine, st, wait);
  });
  flush();
}

// the shape of a run_dag launch: `workers` tiles (0: kDagWarpsPerSm warps
// on every SM), never more than the blocks, in CTAs of 1 to 4 warps that
// put the fewest warps on one SM; returns the CTAs and sets *threads
inline int dag_shape(int blocks, int tw, int workers, int* threads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = std::max(sms, 1);
  const int per_warp = 32 / tw, max_warps = kDagThreads / 32;
  if (workers <= 0) workers = sms * kDagWarpsPerSm * per_warp;
  workers = std::min(workers, blocks);
  const int warps = (workers + per_warp - 1) / per_warp;
  const int wpc = std::min(max_warps, (warps + sms - 1) / sms);
  *threads = 32 * wpc;
  return (warps + wpc - 1) / wpc;
}

// false for a geometry the kernels do not take
inline bool geometry_ok(const G& g) {
  const bool pow2 = !(g.blk_w & (g.blk_w - 1)) && !(g.blk_h & (g.blk_h - 1));
  return g.nbh > 0 && g.nbv > 0 && pow2 && g.blk_w >= 16 && g.blk_w <= 32 &&
         g.blk_h >= 16 && g.blk_h <= 32 && g.H >= g.fh + 2 * BRD &&
         g.W >= g.fw + 2 * BRD && g.hs <= 2 && g.vs <= 2;
}

}  // namespace
