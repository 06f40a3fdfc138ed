// The per-block motion search of the encoder's wavefront (hierarchical,
// over anti-diagonals), shared by the Hopper kernels of csrc/hme_search.cu
// (kernels 4/5: one stream, a warp per block) and csrc/hme_gang.cu (kernels
// 6/7: every stream lane of a lockstep flush, G blocks per warp).
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
// (same-level grids through __ldcg: other tiles wrote them); the half-pel
// grid of a subpel search lives in the tile's slice of shared memory.
// walk_level is the CTA's loop over the diagonals of one level: the tiles
// take the blocks of a diagonal in turn, a barrier between diagonals.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

#define I32MAX 0x7FFFFFFF
#define BRD 32          // FRAME_BORDER
#define SRC_DC_PRED 0x100
#define MASK_ALL_INTRA 15
#define SPD 17
#define HGS 35          // half-pel grid side (34 + a zero row/column)
#define FULL 0xFFFFFFFFu

constexpr int kMaxThreads = 512;  // a CTA: up to 128 registers a thread
constexpr int kHgBytes = 1232;  // HGS * HGS rounded up to 16

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

// a window: its first sample, the plane stride, its static height and
// log2 of its static (power-of-two) width
struct Win {
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
__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }
__device__ __forceinline__ int fdiv(int a, int b) {  // floor, b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int divt(int a, int b) { return a / b; }
__device__ __forceinline__ int sar_r2(int v) { return (v + 2) >> 2; }
__device__ __forceinline__ int uavg4(int a, int b, int c, int d) {
  return (a + b + c + d + 2) >> 2;
}

__device__ __forceinline__ Win win(const Plane& pl, int x, int y, int h,
                                   int w) {
  int y0 = min(max(y + BRD, 0), pl.H - h);
  int x0 = min(max(x + BRD, 0), pl.W - w);
  return Win{pl.p + (size_t)y0 * pl.W + x0, pl.W, h, __ffs(w) - 1};
}
__device__ __forceinline__ int at(const Win& a, int r, int c) {
  return __ldg(a.p + (size_t)r * a.s + c);
}

__device__ unsigned isqrt_u32(unsigned n) {
  unsigned pos = 1u << 30, res = 0, rem = n;
  while (pos) {
    unsigned dif = res + pos;
    res >>= 1;
    if (rem >= dif) {
      rem -= dif;
      res += pos;
    }
    pos >>= 2;
  }
  return res;
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
// same-level fields, written by other warps of the CTA: bypass L1
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
  // tile reductions: every lane of the tile gets the result
  static __device__ __forceinline__ unsigned wsum(unsigned v) {
#pragma unroll
    for (int o = TW / 2; o; o >>= 1) v += __shfl_xor_sync(mask(), v, o, TW);
    return v;
  }
  static __device__ __forceinline__ int wsumi(int v) {
    return (int)wsum((unsigned)v);
  }
  static __device__ __forceinline__ unsigned tile_ballot(bool p) {
    return __ballot_sync(mask(), p) & mask();
  }
  static __device__ __forceinline__ bool tile_any(bool p) {
    return __any_sync(mask(), p);
  }
  static __device__ __forceinline__ void tile_sync() { __syncwarp(mask()); }

  static __device__ int sse(const Win& a, const Win& b, int bw, int bh) {
    if (bw == 0 || bh == 0) return I32MAX;
    unsigned acc = 0;
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) {
      int d = at(a, r, c) - at(b, r, c);
      acc += (unsigned)(d * d);
    }
    return (int)wsum(acc);
  }

  // the reference's 2x2-quad metric accumulator (ref: hme.c:126-196)
  static __device__ unsigned metr_acc(const Win& a, const Win& b, int bw, int bh,
                                      int ew, int tw, int aw) {
    unsigned acc = 0;
    FOR_CELLS(a.h >> 1, a.lw - 1, bw >> 1, bh >> 1, j, i) {
      int a1 = at(a, 2 * j, 2 * i), a2 = at(a, 2 * j, 2 * i + 1);
      int a3 = at(a, 2 * j + 1, 2 * i), a4 = at(a, 2 * j + 1, 2 * i + 1);
      int b1 = at(b, 2 * j, 2 * i), b2 = at(b, 2 * j, 2 * i + 1);
      int b3 = at(b, 2 * j + 1, 2 * i), b4 = at(b, 2 * j + 1, 2 * i + 1);
      int s0 = uavg4(a1, a2, a3, a4), s1 = uavg4(b1, b2, b3, b4);
      int se = uavg4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3),
                     iabs(a4 - b4));
      int ta = uavg4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4),
                     iabs(a4 - a1));
      int tb = uavg4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4),
                     iabs(b4 - b1));
      acc += (unsigned)(se * se) << ew;
      acc += (unsigned)((ta - tb) * (ta - tb)) << tw;
      acc += (unsigned)((s0 - s1) * (s0 - s1)) << aw;
    }
    return wsum(acc);
  }

  static __device__ int metr(const Win& a, const Win& b, int bw, int bh, int ew,
                             int tw, int aw) {
    if (bw == 0 || bh == 0) return I32MAX;
    return metric_return(metr_acc(a, b, bw, bh, ew, tw, aw), bw, bh);
  }

  static __device__ __forceinline__ int hier(int level, const Win& a, const Win& b,
                                             int bw, int bh, int ew, int tw, int aw) {
    return level > 1 ? sse(a, b, bw, bh) : metr(a, b, bw, bh, ew, tw, aw);
  }

  // block features (ref: hme.c:492-749)
  static __device__ void feat_detail(const Win& a, int bw, int bh, int& detail,
                                     int& avg, int& tex) {
    int s = 0, sh = 0, sv = 0;
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) {
      int v = at(a, r, c);
      s += v;
      if (c + 1 < bw) sh += iabs(at(a, r, c + 1) - v);
      if (r + 1 < bh) sv += iabs(at(a, r + 1, c) - v);
    }
    s = wsumi(s);
    sh = wsumi(sh);
    sv = wsumi(sv);
    avg = s / max(bw * bh, 1);
    int var = 0;
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) var += iabs(at(a, r, c) - avg);
    var = wsumi(var);
    int mx = max(sh, sv);
    detail = (var >> 1) + max(mx - (var >> 1), 0);
    tex = mx;
  }

  static __device__ int feat_qtex(const Win& a, int bw, int bh) {
    unsigned sh = 0, sv = 0;
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) {
      int q = at(a, r, c) >> 4;
      if (c + 1 < bw) {
        int d = q - (at(a, r, c + 1) >> 4);
        sh += (unsigned)(d * d);
      }
      if (r + 1 < bh) {
        int d = (at(a, r + 1, c) >> 4) - q;
        sv += (unsigned)(d * d);
      }
    }
    sh = wsum(sh);
    sv = wsum(sv);
    return (int)isqrt_u32(max(sh, sv)) / max((bw + bh + 1) >> 1, 1);
  }

  // 16-bin histogram counted with ballots: every lane ends with all counts;
  // the trip count is uniform in the warp
  template <bool QUADS>
  static __device__ void hist16(const Win& a, int bw, int bh, int q16, int* hist) {
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

  static __device__ int feat_hvar(const Win& a, int bw, int bh, int avg) {
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

  static __device__ int feat_peaks(const Win& a, int bw, int bh, int avg) {
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

  static __device__ int masked_avg(const Win& a, int bw, int bh) {
    int s = 0;
    FOR_CELLS(a.h, a.lw, bw, bh, r, c) s += at(a, r, c);
    return wsumi(s) / max(bw * bh, 1);
  }

  // Greedy walk with retry (ref: hme.c:1300-1370), the plain version's
  // _refine_loop for one block.
  static __device__ void refine(const G& g, const Lv& L, const Win& sw, Res& r,
                                int qthresh) {
    const int level = g.level, step = 1 << level;
    int m[4] = {I32MAX, I32MAX, I32MAX, I32MAX};
    bool done = false;
    while (!done) {
      const int bx0 = r.dx, by0 = r.dy;
      bool improved = false;
      for (int k = 0; k < 5; ++k) {
        const int tvx = bx0 + kRectX[k], tvy = by0 + kRectY[k];
        if (improved ||
            invalid_block(r.bx + tvx, r.by + tvy, r.bw, r.bh, 0, g.fw, g.fh))
          continue;
        const int raw =
            hier(level, sw, win(L.ref, r.bx + tvx, r.by + tvy, g.blk_h, g.blk_w),
                 r.bw, r.bh, r.ew, r.tw, r.aw);
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
        const int sc = wadd(
            hier(level, sw, win(L.ref, r.bx + tvx, r.by + tvy, g.blk_h, g.blk_w),
                 r.bw, r.bh, r.ew, r.tw, r.aw),
            mv_cost(g, r.px, r.py, tvx * step * 4, tvy * step * 4, level > 1));
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

  // Candidate search + refine of block (i, j) (ref: hme.c:1413-1630); false
  // when the block starts outside the level's plane.
  static __device__ bool block_search(const G& g, const Lv& L, int i, int j, Res& r) {
    const int level = g.level, step = 1 << level;
    const int yw = g.blk_w, yh = g.blk_h, fw = g.fw, fh = g.fh;
    r.bx = (i * yw) >> level;
    r.by = (j * yh) >> level;
    if (r.bx >= fw || r.by >= fh) return false;
    r.bw = min(max(fw - r.bx, 0), yw);
    r.bh = min(max(fh - r.by, 0), yh);
    const int bw = r.bw, bh = r.bh;
    const Win sw = win(L.src, r.bx, r.by, yh, yw);
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

    // median predictor (ref: dsv.c:373-400)
    {
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

    // candidates (ref: hme.c:1443-1528), in slot order
    int cx[26], cy[26];
    bool cok[26];
    int n = 0;
    r.lax = r.lay = 0;
    cx[n] = 0;
    cy[n] = 0;
    cok[n++] = true;
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
      if (level == 0) {
        cx[n] = sar_r2(r.px);
        cy[n] = sar_r2(r.py);
        cok[n++] = true;
      }
      const int sdx[3] = {-1, 0, -1}, sdy[3] = {0, -1, -1};
      for (int k = 0; k < 3; ++k) {
        const int xi = i + sdx[k] * step, yj = j + sdy[k] * step;
        const bool ok = xi >= 0 && yj >= 0;
        cx[n] = sar_r2(ok ? out_at(L, g, 0, xi, yj) : 0);
        cy[n] = sar_r2(ok ? out_at(L, g, 1, xi, yj) : 0);
        cok[n++] = ok;
      }
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

    // scale to the level; first strict minimum over the slots, value-equal
    // duplicates of an earlier used slot skipped (ref: hme.c:1522-1566)
    bool use[26];
    int best_score = I32MAX, bdx = 0, bdy = 0, score_zero = I32MAX;
    for (int s = 0; s < n; ++s) {
      const int dx = cx[s] >> level, dy = cy[s] >> level;
      cx[s] = dx;
      cy[s] = dy;
      use[s] = cok[s] && !invalid_block(r.bx + dx, r.by + dy, bw, bh, 0, fw, fh);
      if (!use[s]) continue;
      bool dup = false;
      for (int t = 0; t < s; ++t) dup = dup || (use[t] && cx[t] == dx && cy[t] == dy);
      if (dup) continue;
      const int raw = hier(level, sw, win(L.ref, r.bx + dx, r.by + dy, yh, yw),
                           bw, bh, r.ew, r.tw, r.aw);
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

    // good-enough vs the source reference (ref: hme.c:1569-1584)
    int qthresh = (g.quant * bw * bh) >> 11;
    if (iabs(bdx) <= 1 && iabs(bdy) <= 1) qthresh *= 2;
    const int zos = metr(sw, win(L.ogr, r.bx, r.by, yh, yw), bw, bh, r.ew, r.tw,
                         r.aw);
    r.good = 0;
    if (zos < qthresh) {
      r.dx = r.dy = 0;
      r.best = level == 0 ? score_zero : 0;
      r.good = 1;
      return true;
    }
    r.dx = bdx;
    r.dy = bdy;
    r.best = best_score;
    refine(g, L, sw, r, qthresh);
    return true;
  }

  // The half-pel grid (34 x 34, a zero row/column past it) of a 21x21
  // window whose (1, 1) sample is the probe origin, into the warp's shared
  // slice hg (ref: hme.c:787-815). The quarter-pel samples are derived from
  // it when read (qv).
  static __device__ void hpel_grid(const Plane& pl, int x, int y, uint8_t* hg) {
    const int y0 = min(max(y + BRD, 0), pl.H - 21);
    const int x0 = min(max(x + BRD, 0), pl.W - 21);
    const uint8_t* p = pl.p + (size_t)y0 * pl.W + x0;
    tile_sync();  // every lane is done reading the previous grid
    auto px = [&](int r, int c) { return (int)__ldg(p + (size_t)r * pl.W + c); };
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

  // (ref: hme.c:244-269): srcsp vs q[4 + t1::4, 4 + t0::4]
  static __device__ int qpsad(const Win& a, const uint8_t* hg, int t0, int t1, int ew,
                              int tw, int aw) {
    unsigned acc = 0;
    for (int q = lane(); q < 64; q += TW) {
      const int j = q >> 3, i = q & 7;
      const int y = 4 + t1 + 8 * j, x = 4 + t0 + 8 * i;
      int a1 = at(a, 2 * j, 2 * i), a2 = at(a, 2 * j, 2 * i + 1);
      int a3 = at(a, 2 * j + 1, 2 * i), a4 = at(a, 2 * j + 1, 2 * i + 1);
      int b1 = qv(hg, y, x), b2 = qv(hg, y, x + 4);
      int b3 = qv(hg, y + 4, x), b4 = qv(hg, y + 4, x + 4);
      int s0 = uavg4(a1, a2, a3, a4), s1 = uavg4(b1, b2, b3, b4);
      int se = uavg4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3),
                     iabs(a4 - b4));
      int ta = uavg4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4),
                     iabs(a4 - a1));
      int tb = uavg4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4),
                     iabs(b4 - b1));
      acc += (unsigned)(se * se) << ew;
      acc += (unsigned)((ta - tb) * (ta - tb)) << tw;
      acc += (unsigned)((s0 - s1) * (s0 - s1)) << aw;
    }
    return metric_return(wsum(acc), 16, 16);
  }

  // subpel refine around full-pel (fpx, fpy) (ref: hme.c:1051-1164)
  static __device__ void subpel(const G& g, const Lv& L, const Res& r, const Win& sw,
                                int fpx, int fpy, int best_fp, uint8_t* hg, int& ret,
                                int& sx, int& sy) {
    sx = sy = 0;
    if (best_fp == 0) {
      ret = best_fp;
      return;
    }
    const int bx = r.bx, by = r.by, bw = r.bw, bh = r.bh;
    const int yarea = bw * bh;
    const int dx4[4] = {1, -1, 0, 0}, dy4[4] = {0, 0, 1, -1};
    int quad[4];
    for (int k = 0; k < 4; ++k)
      quad[k] = sse(sw, win(L.ref, bx + fpx + dx4[k], by + fpy + dy4[k],
                            g.blk_h, g.blk_w),
                    bw, bh);
    const int area_ratio = (8 * 16 * 16) / max(yarea, 1);
    const int iarea_ratio = (8 * yarea) / (16 * 16);
    int best = (int)(((unsigned)best_fp * (unsigned)area_ratio) >> 3);
    const int xx = bx + ((bw >> 1) - 8), yy = by + ((bh >> 1) - 8);
    hpel_grid(L.ref, xx + fpx - 2, yy + fpy - 2, hg);
    const Win sp = win(L.src, xx, yy, 16, 16);
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
    int msc = I32MAX, mt0 = 0, mt1 = 0;
    for (int k = 0; k < 7; ++k) {
      const int t0 = t0s[k], t1 = t1s[k];
      if (g.effort < 8 && ((t0 | t1) & 1)) continue;  // half-pel only
      const int sc = wadd(qpsad(sp, hg, t0, t1, r.ew, r.tw, r.aw),
                          mv_cost(g, r.px, r.py, fpx * 4 + t0, fpy * 4 + t1, 0));
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

  // one plane of yuv_max_subblock_err (ref: hme.c:369-409)
  static __device__ unsigned max_sub(const Plane& pa, const Plane& pb, int x0, int y0,
                                     int rx, int ry, int qw, int qh, int bw2, int bh2,
                                     const Res& r) {
    unsigned m = 0;
    for (int k = 0; k < 4; ++k) {
      const int f = k & 1, gq = k >> 1;
      m = max(m, metr_acc(win(pa, x0 + f * bw2, y0 + gq * bh2, qh, qw),
                          win(pb, rx + f * bw2, ry + gq * bh2, qh, qw), bw2, bh2,
                          r.ew, r.tw, r.aw));
    }
    return m;
  }

  // err_intra with psy (0, 1, 2) (ref: hme.c:839-889)
  static __device__ void err_intra(const Win& a, const Win& b, int bw, int bh,
                                   int avg_sb, int avg_src, unsigned ratio,
                                   unsigned& isb, unsigned& isrc, unsigned& inter) {
    isb = isrc = inter = 0;
    FOR_CELLS(a.h >> 1, a.lw - 1, bw >> 1, bh >> 1, j, i) {
      int a1 = at(a, 2 * j, 2 * i), a2 = at(a, 2 * j, 2 * i + 1);
      int a3 = at(a, 2 * j + 1, 2 * i), a4 = at(a, 2 * j + 1, 2 * i + 1);
      int b1 = at(b, 2 * j, 2 * i), b2 = at(b, 2 * j, 2 * i + 1);
      int b3 = at(b, 2 * j + 1, 2 * i), b4 = at(b, 2 * j + 1, 2 * i + 1);
      int s0 = uavg4(a1, a2, a3, a4), s1 = uavg4(b1, b2, b3, b4);
      int ta = uavg4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4),
                     iabs(a4 - a1));
      int tb = uavg4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4),
                     iabs(b4 - b1));
      int ae = uavg4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3),
                     iabs(a4 - b4));
      inter += ((unsigned)(ae * ae) * ratio) >> 5;
      inter += (unsigned)((ta - tb) * (ta - tb)) << 1;
      inter += (unsigned)((s0 - s1) * (s0 - s1)) << 2;
      ae = uavg4(iabs(a1 - avg_sb), iabs(a2 - avg_sb), iabs(a3 - avg_sb),
                 iabs(a4 - avg_sb));
      isb += (unsigned)(ae * ae) + ((unsigned)(ta * ta) << 1) +
             ((unsigned)((s0 - avg_sb) * (s0 - avg_sb)) << 3);
      ae = uavg4(iabs(a1 - avg_src), iabs(a2 - avg_src), iabs(a3 - avg_src),
                 iabs(a4 - avg_src));
      isrc += (unsigned)(ae * ae) + ((unsigned)(ta * ta) << 1) +
              ((unsigned)((s0 - avg_src) * (s0 - avg_src)) << 3);
    }
    isb = wsum(isb);
    isrc = wsum(isrc);
    inter = (wsum(inter) * ratio) >> 5;
  }

  static __device__ void eprm_clips(const Win& s, const Win& rf, int bw, int bh,
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
  // Lane 0 writes the block's grid entries; every lane adds its stats to
  // st[4] (identical in the warp).
  static __device__ void level0_block(const G& g, const Lv& L, int i, int j,
                                      uint8_t* hg, int* st) {
    Res r;
    if (!block_search(g, L, i, j, r)) return;
    const int yw = g.blk_w, yh = g.blk_h, fw = g.fw, fh = g.fh;
    const int bx = r.bx, by = r.by, bw = r.bw, bh = r.bh;
    const int yarea = bw * bh, area1 = max(yarea, 1);
    const int skipt = (g.quant * g.quant) >> 19;
    const Win sw = win(L.src, bx, by, yh, yw);
    int best = (r.dx == r.lax && r.dy == r.lay) ? wadd(r.best, r.mbias) : r.best;
    const int best_fp = best;
    int sub_x = 0, sub_y = 0, fpelx = r.dx, fpely = r.dy;
    if (g.effort >= 4) {
      const bool cond1 = !invalid_block(bx + r.lax, by + r.lay, bw, bh, 4, fw, fh);
      int ret1 = 0, sx1 = 0, sy1 = 0;
      if (cond1) {
        subpel(g, L, r, sw, r.lax, r.lay, best_fp, hg, ret1, sx1, sy1);
        best = ret1;
      }
      const bool found1 = cond1 && (sx1 != 0 || sy1 != 0);
      const bool cond2 = !found1 && !r.good &&
                         !invalid_block(bx + r.dx, by + r.dy, bw, bh, 4, fw, fh);
      if (cond2) {
        int ret2, sx2, sy2;
        subpel(g, L, r, sw, r.dx, r.dy, best_fp, hg, ret2, sx2, sy2);
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
    const Win rfw = win(L.ref, bx + fpelx, by + fpely, yh, yw);
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
    const int uavg_src = masked_avg(win(L.su, cbx, cby, ch_max, cw_max), cbw, cbh);
    const int vavg_src = masked_avg(win(L.sv, cbx, cby, ch_max, cw_max), cbw, cbh);
    const int uavg_ref = masked_avg(win(L.ru, cbmx, cbmy, ch_max, cw_max), cbw, cbh);
    const int vavg_ref = masked_avg(win(L.rv, cbmx, cbmy, ch_max, cw_max), cbw, cbh);
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
        int d_, a_, utex, vtex;
        feat_detail(win(L.su, cbx, cby, ch_max, cw_max), cbw, cbh, d_, a_, utex);
        feat_detail(win(L.sv, cbx, cby, ch_max, cw_max), cbw, cbh, d_, a_, vtex);
        c_pre = c_pre && (utex > carea || vtex > carea);
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
      for (int k = 0; k < 4 && !skip_all; ++k) {
        const int f = k & 1, gq = k >> 1;
        const Win sd = win(L.src, bx + f * sbw, by + gq * sbh, qh, qw);
        const Win md = win(L.ref, bx + fpelx + f * sbw, by + fpely + gq * sbh,
                           qh, qw);
        int d_, avg_sub, t_, local_detail, avg_local;
        feat_detail(md, sbw, sbh, d_, avg_sub, t_);
        feat_detail(sd, sbw, sbh, local_detail, avg_local, t_);
        const int dcd = iabs(avg_local - avg_sub) + 2;
        if ((unsigned)local_detail >
            (((unsigned)wmul(wmul(dcd, dcd), yarea) * ratio_u) >> 5))
          continue;
        const int dc = (avg_local + avg_src * 3 + 2) >> 2;
        unsigned se_sub, se_src, inter;
        err_intra(sd, md, sbw, sbh, avg_sub, dc, ratio_u, se_sub, se_src, inter);
        const int lo = wadd(wadd(detail_src, local_detail), 1) >> 1;
        const int lerp =
            wadd(wmul(lo, 32 - g.psyf), wmul(detail_src, g.psyf)) >> 5;
        const unsigned ld2 = (unsigned)max(lerp, lo);
        if (se_sub + ld2 < inter || se_src + ld2 < inter) {
          submask |= 1 << k;
          err_src += se_src;
          err_sub += se_sub;
          avg_tot += se_sub < se_src ? avg_sub : dc;
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
        int add = 0;
        for (int k = 0; k < 4; ++k) {
          if (submask & (1 << k)) continue;
          const int f = k & 1, gq = k >> 1;
          const int us = masked_avg(win(L.su, cbx + f * sbw, cby + gq * sbh, qh, qw), sbw, sbh);
          const int vs = masked_avg(win(L.sv, cbx + f * sbw, cby + gq * sbh, qh, qw), sbw, sbh);
          const int ur = masked_avg(win(L.ru, cbmx + f * sbw, cbmy + gq * sbh, qh, qw), sbw, sbh);
          const int vr = masked_avg(win(L.rv, cbmx + f * sbw, cbmy + gq * sbh, qh, qw), sbw, sbh);
          const int dif =
              wmul(wadd(wmul(us - ur, us - ur), wmul(vs - vr, vs - vr)), ramp) >> 8;
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

// One level of one stream: the CTA walks the level's anti-diagonals, its
// tiles take the blocks of a diagonal in turn (tile-uniform), a barrier
// between diagonals; tiles past the diagonal's run write nothing. At level
// 0 the frame sums are added to sums (4,). smem: kHgBytes per tile.
template <int TW, bool L0>
__device__ void walk_level(const G& g, const Lv& L, int* sums, uint8_t* smem) {
  using T = Tile<TW>;
  const int step = 1 << g.level;
  const int ca = (g.nbh + step - 1) / step, cb = (g.nbv + step - 1) / step;
  const int nd = ca + cb - 1, lmax = min(ca, cb);
  const int tile = threadIdx.x / TW, ntiles = blockDim.x / TW;
  uint8_t* hg = smem + tile * kHgBytes;
  int st[4] = {0, 0, 0, 0};
  for (int d = 0; d < nd; ++d) {
    const int a0 = max(0, d - (cb - 1));
    for (int k = tile; k < lmax; k += ntiles) {
      const int a = a0 + k, b = d - a;
      if (a >= ca || b < 0 || b >= cb) break;
      const int i = a * step, j = b * step;
      if (L0) {
        T::level0_block(g, L, i, j, hg, st);
      } else {
        Res r;
        if (T::block_search(g, L, i, j, r) && T::lane() == 0) {
          L.out[j * g.nbh + i] = r.dx * step;
          L.out[g.nbv * g.nbh + j * g.nbh + i] = r.dy * step;
        }
      }
    }
    __syncthreads();  // diagonal d is in the grids
  }
  if (L0 && T::lane() == 0)
    for (int k = 0; k < 4; ++k) atomicAdd(sums + k, st[k]);
}

// the tiles of TW lanes one CTA runs for a level: one per block of the
// longest diagonal, at most kMaxThreads / TW
inline int level_tiles(const G& g, int tw) {
  const int step = 1 << g.level;
  const int ca = (g.nbh + step - 1) / step, cb = (g.nbv + step - 1) / step;
  return std::min(std::min(ca, cb), kMaxThreads / tw);
}

// false for a geometry the kernels do not take
inline bool geometry_ok(const G& g) {
  const bool pow2 = !(g.blk_w & (g.blk_w - 1)) && !(g.blk_h & (g.blk_h - 1));
  return g.nbh > 0 && g.nbv > 0 && pow2 && g.blk_w >= 16 && g.blk_w <= 32 &&
         g.blk_h >= 16 && g.blk_h <= 32 && g.H >= g.fh + 2 * BRD &&
         g.W >= g.fw + 2 * BRD && g.hs <= 2 && g.vs <= 2;
}

}  // namespace
