// The rice vk adaptation chain of the on-device entropy scan, for Hopper.
//
// Replaces the TPU kernel dsv2_tpu/ops/scan_pl.py::_vk_vec_batched
// (kernel body at :148, reached through _vk_call :204 from make_scan_blob
// :411). Semantics (plain version: dsv2_tpu_torch/ops/scan_pl.py
// vk_chain_plain): B independent chains over a time-major thr (npad, B)
// int32. Chain b walks rows [s0_b, nnz_b) in order, stores the PRE-update
// vk, then sets vk <- vk+1 if vk < thr[i][b] else max(vk-1, 0). Every row
// of vkpre is defined: 0 below s0, the final vk at and above nnz.
//
// What bounds it: a chain is one sequential dependence (a compare and a
// predicated add a row), ~0.5M rows long at FHD luma. Walked by one
// thread from device memory it is bound by load latency (~48 ns a row);
// fed from shared memory, by its dependence and the instructions around
// it (~20 ns a row a walker on the card). The bytes (thr read once, vkpre
// written once) bound the call at ~0.05 ms. So the chain is cut into
// chunks of L rows that are walked at once, speculatively, and then
// resolved exactly. Three passes on the stream:
//
// 1. vk_spec_kernel, every chunk of every chain at once on every SM. A
//    CTA takes K consecutive chunks of all B chains: one walker thread per
//    (chunk, chain), and a producer warp that keeps a ring of stages of
//    kS rows of thr (all B columns, time-major) in shared memory, ahead of
//    the walkers, by bulk asynchronous copies completing on mbarriers
//    (csrc/vk_async.cuh); the walkers never wait on device memory. A
//    walker starts W rows before its chunk (or at s0, where that is later:
//    then its walk is exact) and walks two candidates, vk = 0 and 1: each
//    step moves vk by +-1, so the parity of vk + row is fixed except where
//    the clamp (vk = 0, thr = 0) holds vk, and a trajectory can only meet
//    the true one from the same parity. Where the clamp merges the two
//    during the warm-up they are split again. The walker writes both
//    candidates' pre-update values of each row of its chunk into vkpre,
//    packed as two uint16 (a candidate starts at 0 or 1 and walks < 65535
//    rows), and a head per chunk: both candidates' values at its first
//    row and after its last, and its first kHead rows of thr and packed
//    values. Bound by the walk: W + L rows, every walker in parallel.
// 2. vk_resolve_kernel, one CTA per chain, exact. A producer thread
//    streams the chain's heads through a ring in shared memory; a warp
//    takes them 32 chunks at a time. The true vk entering chunk c is the
//    true end of chunk c - 1. If it equals a candidate's value at the
//    chunk's first row, the chunk stands as that candidate wrote it (the
//    walk is deterministic) and its end is that candidate's end: each
//    chunk is a table from the candidate its predecessor ended in to the
//    one it starts in, and a scan over the lanes composes the tables, so a
//    run of chunks that meet resolves in one step. A chunk that meets
//    neither is re-walked by the warp from its true start (every lane
//    walks the chain and keeps and stores its own row of each 32), writing
//    true values, until the true vk equals a candidate's value at some row
//    (from there on they are identical) or the chunk ends; the true end
//    carries on. The re-walk reads the head's rows, then stages of thr and
//    vkpre that it copies into shared memory, the next one ahead. The
//    result is exact for every input; a chain that never meets a
//    candidate costs one sequential walk fed from shared memory. Bound by
//    the re-walked rows.
// 3. vk_final_kernel, every element in place: the chosen candidate's half
//    of a live row that was not re-walked, 0 below s0, the chain's final
//    vk at and above nnz. Bound by bytes.
//
// Pass 1 writes with plain stores: staging each walker's 32 rows through
// shared memory to a chain-major scratch costs a bulk store per walker,
// array and stage, and measured slower (0.20 against 0.15 ms on 2^21 x 16
// rows, NVIDIA H100, tools/torch_profile.py --vk). No size takes a
// single-warp walk (one warp over the union of its chains' ranges): it is
// slower at every size measured, down to a CIF lane's 2k rows. nnz and s0
// are read on the device: the host never reads them. The wrapper
// (ops/_kernels.vk_chain) allocates the scratch; nothing here allocates
// or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vk_async.cuh"

namespace {

constexpr int kS = 32;            // rows per pass-1 stage
constexpr int kMaxStages = 8;     // pass-1 ring depth at most
constexpr int kMaxChains = 256;   // B per launch at most
constexpr int kSmemMax = 232448;  // opt-in shared bytes per block
constexpr int kHead = 30;         // rows of a chunk's head
constexpr int kHeadWords = 64;    // a head: 4 values, kHead thr, kHead packed
constexpr int kHeadStages = 8;    // pass-2 head ring depth
constexpr int kDeepElems = 4096;  // rows x chains of a pass-2 re-walk stage

__device__ __forceinline__ int vk_step(int vk, int t) {
  return vk < t ? vk + 1 : max(vk - 1, 0);
}

__device__ __forceinline__ int pack(int va, int vb) {
  return (va & 0xffff) | (vb << 16);
}

// whether the true vk t meets a candidate of packed values p (0: the
// first, 1: the second, 2: neither)
__device__ __forceinline__ int meets(int t, int p) {
  return t == (p & 0xffff) ? 0 : t == (int)((uint32_t)p >> 16) ? 1 : 2;
}

struct Geo {
  const int* thr;
  const int* s0;
  const int* nnz;
  int* out;    // (npad, B): packed candidates, then vkpre
  int* heads;  // (B, nchunk, kHeadWords)
  int* dec;    // (B, nchunk, 2): candidate chosen, first row it holds
  int* fin;    // (B,) final vk
  int* stats;  // null, or 5 counters (dsv2t_vk_chain)
  int npad, nb, L, lgL, W, nchunk;
  int K, ns, seg, cwarps, off_ring;  // pass 1
  int S3;                            // pass 2: rows of a re-walk stage
};

__device__ __forceinline__ void chain_range(const Geo& g, int b, int& lo,
                                            int& hi) {
  lo = min(max(__ldg(g.s0 + b), 0), g.npad);
  hi = max(min(__ldg(g.nnz + b), g.npad), lo);
}

// Pass 1. Block: cwarps walker warps (thread t walks chunk c0 + t / B of
// chain t % B) and one producer warp.
__global__ void __launch_bounds__(288) vk_spec_kernel(Geo g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* ulo = reinterpret_cast<int*>(smem + 2 * kMaxStages * 8);
  int* uhi = ulo + g.K;
  int* ring = reinterpret_cast<int*>(smem + g.off_ring);
  const int tid = threadIdx.x, lane = tid & 31;
  const int ncons = g.cwarps * 32;
  const int c0 = blockIdx.x * g.K;
  // rows any walker of chunk k reads, rounded out to 16-byte copies
  if (tid < g.K) {
    int u0 = g.npad, u1 = 0;
    const int c = c0 + tid;
    if (c < g.nchunk) {
      const int cL = c * g.L;
      for (int b = 0; b < g.nb; ++b) {
        int lo, hi;
        chain_range(g, b, lo, hi);
        if (max(cL, lo) < min(cL + g.L, hi)) {
          u0 = min(u0, max(cL - g.W, lo));
          u1 = max(u1, min(cL + g.L, hi));
        }
      }
    }
    ulo[tid] = u0 & ~3;
    uhi[tid] = min((u1 + 3) & ~3, g.npad);
  }
  if (tid == 0) {
    for (int s = 0; s < g.ns; ++s) {
      vka::bar_init(full + s, 1);
      vka::bar_init(empty + s, g.cwarps);
    }
    vka::bar_init_fence();
  }
  __syncthreads();
  bool any = false;
  for (int k = 0; k < g.K; ++k) any |= ulo[k] < uhi[k];
  if (!any) return;
  const int nst = (g.W + g.L) / kS;

  if (tid >= ncons) {  // the producer warp
    for (int j = 0, s = 0, ph = 0; j < nst; ++j) {  // stage s of round ph
      if (j >= g.ns) vka::bar_wait(empty + s, ph ^ 1);
      uint32_t bytes = 0;
      for (int k = lane; k < g.K; k += 32) {
        const int r0 = (c0 + k) * g.L - g.W + j * kS;
        const int a = max(r0, ulo[k]), e = min(r0 + kS, uhi[k]);
        if (a < e) bytes += (uint32_t)(e - a) * g.nb * 4;
      }
      for (int o = 16; o; o >>= 1) bytes += __shfl_xor_sync(~0u, bytes, o);
      if (lane == 0) {
        if (bytes)
          vka::bar_expect(full + s, bytes);
        else
          vka::bar_arrive(full + s);
      }
      __syncwarp();
      for (int k = lane; k < g.K; k += 32) {
        const int r0 = (c0 + k) * g.L - g.W + j * kS;
        const int a = max(r0, ulo[k]), e = min(r0 + kS, uhi[k]);
        if (a < e)
          vka::bulk_load(ring + (s * g.K + k) * g.seg + (a - r0) * g.nb,
                         g.thr + (size_t)a * g.nb,
                         (uint32_t)(e - a) * g.nb * 4, full + s);
      }
      if (++s == g.ns) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  const int k = tid / g.nb, b = tid - k * g.nb;
  const int c = c0 + k, cL = c * g.L;
  int lo = 0, a = 0, e = 0, ws = 0;
  bool live = false;
  if (k < g.K && c < g.nchunk) {
    int hi;
    chain_range(g, b, lo, hi);
    a = max(cL, lo);
    e = min(cL + g.L, hi);
    ws = max(cL - g.W, lo);
    live = a < e;
  }
  // from s0 the walk is exact: both candidates 0
  int va = 0, vb = ws > lo ? 1 : 0, pa = 0, pb = 0;
  int* head = g.heads + ((size_t)b * g.nchunk + c) * kHeadWords;
  const int* in_k = ring + k * g.seg + b;
  const int jout = g.W / kS;
  for (int j = 0, s = 0, ph = 0; j < nst; ++j) {  // stage s of round ph
    if (j == jout) {
      pa = va;
      pb = vb;
    }
    vka::bar_wait(full + s, ph);
    const int r0 = cL - g.W + j * kS;
    const int j0 = max(ws, r0) - r0, j1 = min(e, r0 + kS) - r0;
    if (live && j0 < j1) {
      // a whole stage's rows are loaded before its chain is walked
      const int* in = in_k + s * g.K * g.seg;
      int* o = g.out + (size_t)r0 * g.nb + b;
      if (j0 == 0 && j1 == kS) {
        int th[kS];
#pragma unroll
        for (int q = 0; q < kS; ++q) th[q] = in[q * g.nb];
        if (j >= jout) {
#pragma unroll
          for (int q = 0; q < kS; ++q) {
            const int p = pack(va, vb);
            o[(size_t)q * g.nb] = p;
            if (q < kHead && j == jout) {
              head[4 + q] = th[q];
              head[4 + kHead + q] = p;
            }
            va = vk_step(va, th[q]);
            vb = vk_step(vb, th[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kS; ++q) {
            va = vk_step(va, th[q]);
            vb = vk_step(vb, th[q]);
          }
        }
      } else {
        for (int q = j0; q < j1; ++q) {
          const int t = in[q * g.nb];
          if (j >= jout) {
            const int p = pack(va, vb);
            o[(size_t)q * g.nb] = p;
            if (q < kHead && j == jout) {
              head[4 + q] = t;
              head[4 + kHead + q] = p;
            }
          }
          va = vk_step(va, t);
          vb = vk_step(vb, t);
        }
      }
      // warm-up: where the clamp merged the candidates, split them again
      // (the rows before the chunk are not recorded)
      if (j < jout) vb += va == vb;
    }
    __syncwarp();
    if (lane == 0) vka::bar_arrive(empty + s);
    if (++s == g.ns) {
      s = 0;
      ph ^= 1;
    }
  }
  if (live) {
    head[0] = pa;
    head[1] = pb;
    head[2] = va;
    head[3] = vb;
  }
}

// The two re-walk stages of pass 2: rows [r0, r0 + S3) of thr and vkpre
// (all columns) copied into shared memory, the next one ahead. Every lane
// of the warp keeps the same state; `lead` issues the copies.
struct Deep {
  int* thr;
  int* out;
  uint64_t* bar;
  unsigned phase = 0, pend = 0;  // bit x: stage x's parity, load in flight

  // every lane sees stage x land before the lead may copy into it again
  // (a lane that missed a phase would wait for the next one forever)
  __device__ void settle(int x) {
    if (pend >> x & 1) {
      vka::bar_wait(bar + x, phase >> x & 1);
      phase ^= 1u << x;
      pend &= ~(1u << x);
      __syncwarp();
    }
  }
  __device__ void issue(const Geo& g, int x, int r0, bool lead) {
    settle(x);
    if (lead) {
      const uint32_t bytes =
          (uint32_t)(min(r0 + g.S3, g.npad) - r0) * g.nb * 4;
      vka::bar_expect(bar + x, 2 * bytes);
      vka::bulk_load(thr + x * kDeepElems, g.thr + (size_t)r0 * g.nb, bytes,
                     bar + x);
      vka::bulk_load(out + x * kDeepElems, g.out + (size_t)r0 * g.nb, bytes,
                     bar + x);
    }
    pend |= 1u << x;
  }
};

// Up to 32 rows of a re-walk, by the whole warp (t uniform): every lane
// walks the true trajectory (the chain) and keeps the value of its own
// row, which it then tests against the candidates th(q), pk(q) of row q
// give and stores (row q at out[q * nb]) if no row before it met one.
// Returns the rows before the first that meets a candidate (mode: its
// 0/1), or n (mode 2, t the true vk after them).
template <class TH, class PK>
__device__ int walk_group(int& t, int n, TH th, PK pk, int* out, int nb,
                          int& mode) {
  const int lane = threadIdx.x & 31;
  int mine = 0, tt = t;
  if (n == 32) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      if (q == lane) mine = tt;
      tt = vk_step(tt, th(q));
    }
  } else {
    for (int q = 0; q < n; ++q) {
      if (q == lane) mine = tt;
      tt = vk_step(tt, th(q));
    }
  }
  const int m = lane < n ? meets(mine, pk(lane)) : 2;
  const unsigned hit = __ballot_sync(~0u, m != 2);
  const int f = hit ? __ffs(hit) - 1 : n;
  if (lane < f) out[(size_t)lane * nb] = mine;
  mode = __shfl_sync(~0u, m, hit ? f : 0);
  if (!hit) {
    mode = 2;
    t = tt;
  }
  return f;
}

// Re-walk chunk [cL, e) of chain b (head h) from the true vk t at cL, by
// the whole warp: true values into vkpre until t meets a candidate
// (returns its 0/1, and the row in `r`) or the chunk ends (returns 2, t
// the true end).
__device__ int rewalk(const Geo& g, int b, const int* h, int cL, int e,
                      int& t, int& r, Deep& dp) {
  const int nb = g.nb;
  const bool lead = (threadIdx.x & 31) == 0;
  int* out = g.out + b;
  int mode;
  r = cL + walk_group(
               t, min(e, cL + kHead) - cL, [&](int q) { return h[4 + q]; },
               [&](int q) { return h[4 + kHead + q]; },
               out + (size_t)cL * nb, nb, mode);
  if (mode != 2 || r >= e) return mode;
  int r0 = r & ~3, x = 0;
  dp.issue(g, 0, r0, lead);
  if (r0 + g.S3 < e) dp.issue(g, 1, r0 + g.S3, lead);
  while (true) {
    dp.settle(x);
    const int* th = dp.thr + x * kDeepElems + b;
    const int* pk = dp.out + x * kDeepElems + b;
    const int j1 = min(e, r0 + g.S3) - r0;
    for (int j = r - r0; j < j1;) {
      j += walk_group(
          t, min(32, j1 - j), [&](int q) { return th[(j + q) * nb]; },
          [&](int q) { return pk[(j + q) * nb]; },
          out + (size_t)(r0 + j) * nb, nb, mode);
      r = r0 + j;
      if (mode != 2) return mode;
    }
    if (r >= e) return 2;
    if (r0 + 2 * g.S3 < e) dp.issue(g, x, r0 + 2 * g.S3, lead);
    x ^= 1;
    r0 += g.S3;
  }
}

// the option table of a run of chunks: for the option (0: the first
// candidate, 1: the second) the run's first chunk starts in, the option
// its last chunk starts in, or 2 (no candidate): two 2-bit entries.
// compose(f, s) is the run f followed by the run s.
__device__ __forceinline__ int compose(int f, int s) {
  const int f0 = f & 3, f1 = f >> 2 & 3;
  const int r0 = f0 == 2 ? 2 : s >> 2 * f0 & 3;
  const int r1 = f1 == 2 ? 2 : s >> 2 * f1 & 3;
  return r0 | r1 << 2;
}

// Pass 2. Block b resolves chain b: warp 0 takes its chunks 32 at a time
// (lane k the k-th chunk of a window), thread 32 streams the heads.
__global__ void __launch_bounds__(64) vk_resolve_kernel(Geo g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kHeadStages;
  int* ring = reinterpret_cast<int*>(smem + (2 * kHeadStages + 2) * 8);
  Deep dp;
  dp.bar = empty + kHeadStages;
  dp.thr = ring + kHeadStages * 32 * kHeadWords;
  dp.out = dp.thr + 2 * kDeepElems;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  int lo, hi;
  chain_range(g, b, lo, hi);
  if (lo >= hi) {
    if (tid == 0) g.fin[b] = 0;
    return;
  }
  const int cf = lo >> g.lgL, nh = ((hi - 1) >> g.lgL) - cf + 1;
  const int nwin = (nh + 31) / 32;
  if (tid == 0) {
    for (int s = 0; s < kHeadStages; ++s) {
      vka::bar_init(full + s, 1);
      vka::bar_init(empty + s, 1);
    }
    vka::bar_init(dp.bar, 1);
    vka::bar_init(dp.bar + 1, 1);
    vka::bar_init_fence();
  }
  __syncthreads();
  const int* heads = g.heads + ((size_t)b * g.nchunk + cf) * kHeadWords;

  if (tid >= 32) {
    if (tid == 32) {  // the producer
      for (int w = 0; w < nwin; ++w) {
        const int s = w % kHeadStages;
        if (w >= kHeadStages)
          vka::bar_wait(empty + s, ((w / kHeadStages) - 1) & 1);
        const uint32_t bytes = min(32, nh - w * 32) * kHeadWords * 4;
        vka::bar_expect(full + s, bytes);
        vka::bulk_load(ring + s * 32 * kHeadWords,
                       heads + (size_t)w * 32 * kHeadWords, bytes, full + s);
      }
    }
    return;
  }

  // chunks whose true start met a candidate, re-walks that met one, rows
  // re-walked (lane 0)
  int n_met = 0, n_remet = 0, n_rows = 0;
  int t = 0;  // the true vk entering the window's next chunk
  for (int w = 0; w < nwin; ++w) {
    const int s = w % kHeadStages;
    vka::bar_wait(full + s, (w / kHeadStages) & 1);
    const int i = w * 32 + lane;
    const bool valid = i < nh;
    const int* h = ring + (s * 32 + lane) * kHeadWords;
    const int pa = valid ? h[0] : -1, pb = valid ? h[1] : -1;
    const int ea = valid ? h[2] : -1, eb = valid ? h[3] : -1;
    const int c = cf + i, a = max(c * g.L, lo);
    int* d = g.dec + ((size_t)b * g.nchunk + c) * 2;
    auto opt = [&](int v) { return v == pa ? 0 : v == pb ? 1 : 2; };
    // the option this chunk starts in, from the option of the one before
    const int pea = __shfl_up_sync(~0u, ea, 1);
    const int peb = __shfl_up_sync(~0u, eb, 1);
    const int own = valid ? opt(pea) | opt(peb) << 2 : 10;
    int p = 0;
    while (true) {
      int tab = lane <= p ? 4 : own;  // identity at and below p
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(~0u, tab, off);
        if (lane >= off) tab = compose(o, tab);
      }
      const int op = __shfl_sync(~0u, opt(t), p);
      const int o = op == 2 ? 2 : tab >> 2 * op & 3;
      const unsigned miss = __ballot_sync(~0u, lane >= p && o == 2);
      const int q = miss ? __ffs(miss) - 1 : 32;
      if (lane >= p && lane < q) {
        d[0] = o;
        d[1] = a;
      }
      const int endo = o == 0 ? ea : eb;
      const int tq = q == p ? t : __shfl_sync(~0u, endo, (q + 31) & 31);
      n_met += q - p;
      t = tq;
      if (q == 32 || w * 32 + q >= nh) break;  // the window is resolved
      {  // chunk q: a re-walk from its true start, by the whole warp
        const int* hq = ring + (s * 32 + q) * kHeadWords;
        const int cq = cf + w * 32 + q, cL = cq * g.L;
        const int e = min(cL + g.L, hi);
        int r;
        const int mode = rewalk(g, b, hq, cL, e, t, r, dp);
        n_rows += r - cL;
        if (mode != 2) {
          n_remet += 1;
          t = mode == 0 ? hq[2] : hq[3];
        }
        if (lane == 0) {
          int* dq = g.dec + ((size_t)b * g.nchunk + cq) * 2;
          dq[0] = mode == 1;
          dq[1] = mode == 2 ? e : r;
        }
      }
      p = q + 1;
      if (p >= 32) break;
    }
    __syncwarp();
    if (lane == 0) vka::bar_arrive(empty + s);
  }
  dp.settle(0);
  dp.settle(1);
  if (lane == 0) {
    g.fin[b] = t;
    if (g.stats) {
      atomicAdd(g.stats + 0, nh);
      atomicAdd(g.stats + 1, n_met);
      atomicAdd(g.stats + 2, nh - n_met);
      atomicAdd(g.stats + 3, n_remet);
      atomicAdd(g.stats + 4, n_rows);
    }
  }
}

// Pass 3, in place: elements 4v .. 4v + 3 of vkpre (e = r * B + b; npad
// is a multiple of 4), each row's value from its chain's range, decision
// and packed candidates.
__global__ void __launch_bounds__(256) vk_final_kernel(Geo g) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* lo_s = reinterpret_cast<int*>(smem);
  int* hi_s = lo_s + g.nb;
  int* fin_s = hi_s + g.nb;
  const int nb = g.nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    chain_range(g, b, lo_s[b], hi_s[b]);
    fin_s[b] = g.fin[b];
  }
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  const int v0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = 4 * stride, dr = step / nb, db = step - dr * nb;
  int r = 4 * v0 / nb, b = 4 * v0 - r * nb;
  int4* out4 = reinterpret_cast<int4*>(g.out);
  for (size_t v = v0; v < (size_t)g.npad * nb / 4; v += stride) {
    int val[4], pick[4];  // pick: 0/1 a candidate's half, 2 as stored
    bool read = false;
    int rk = r, bk = b;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pick[k] = 3;
      if (rk >= hi_s[bk]) {
        val[k] = fin_s[bk];
      } else if (rk < lo_s[bk]) {
        val[k] = 0;
      } else {
        const int* d = g.dec + ((size_t)bk * g.nchunk + (rk >> g.lgL)) * 2;
        pick[k] = rk < d[1] ? 2 : d[0];
        read = true;
      }
      if (++bk == nb) {
        bk = 0;
        ++rk;
      }
    }
    if (read) {
      const int4 p4 = out4[v];
      const int p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (pick[k] != 3)
          val[k] = pick[k] == 2   ? p[k]
                   : pick[k] == 1 ? (int)((uint32_t)p[k] >> 16)
                                  : (p[k] & 0xffff);
    }
    out4[v] = make_int4(val[0], val[1], val[2], val[3]);
    r += dr;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++r;
    }
  }
}

int ilog2(int x) {
  int r = 0;
  while ((1 << (r + 1)) <= x) ++r;
  return r;
}

}  // namespace

// The vk chain of B = nb chains (thr/out (npad, nb), s0/nnz (nb,) int32,
// device pointers) on `stream`: chunks of `chunk` rows (a power of two,
// 32..16384), `warmup` rows of warm-up (a multiple of 32, chunk + warmup <
// 65535), about `walkers` (at most 256) pass-1 walker threads per block.
// `passes` is a
// mask of the passes to launch (7: all; the profiler times them apart).
// `scratch` holds 4 * (66 nb nchunk + nb rounded up to 4) bytes (nchunk =
// ceil(npad / chunk); the wrapper's _kernels.vk_scratch_bytes); `stats`,
// if not null, gets 5 int counters added (pass 2): live chunks, chunks
// whose true start met a candidate, chunks re-walked, re-walks that met a
// candidate, rows re-walked. npad is a multiple of 4, thr and scratch
// 16-byte aligned. Returns a cudaError_t (0 = ok); allocates nothing,
// does not sync.
extern "C" int dsv2t_vk_chain(const int* thr, const int* s0, const int* nnz,
                              int* out, void* scratch, int npad, int nb,
                              int chunk, int warmup, int walkers, int passes,
                              int* stats, void* stream) {
  if (npad < 4 || npad % 4 || nb < 1 || nb > kMaxChains || chunk < 32 ||
      chunk > 16384 || (chunk & (chunk - 1)) || warmup < 0 || warmup % kS ||
      chunk + warmup >= 65535 || walkers < 1 || ((uintptr_t)thr & 15) ||
      ((uintptr_t)out & 15) || ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.thr = thr;
  g.s0 = s0;
  g.nnz = nnz;
  g.out = out;
  g.npad = npad;
  g.nb = nb;
  g.L = chunk;
  g.lgL = ilog2(chunk);
  g.W = warmup;
  g.nchunk = (npad + chunk - 1) / chunk;
  g.heads = static_cast<int*>(scratch);
  g.dec = g.heads + (size_t)kHeadWords * nb * g.nchunk;
  g.fin = g.dec + 2 * (size_t)nb * g.nchunk;
  g.stats = stats;
  // per device, once: the SM count and the shared bytes each kernel was
  // opted into (those host calls cost a small launch as much as its run;
  // callers on several host threads may race to set them, harmlessly)
  static int sms[64], opted[64][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  int nsm = __atomic_load_n(&sms[dev], __ATOMIC_ACQUIRE);
  if (!nsm) {
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    __atomic_store_n(&sms[dev], nsm, __ATOMIC_RELEASE);
  }

  // pass 1: K chunks a block, about two blocks per SM where the chunks
  // allow, each chunk segment of a stage kS x nb words padded to 4 mod 32
  int K = (g.nchunk + 2 * nsm - 1) / (2 * nsm);
  K = min(max(K, 1), max(1, min(walkers, 256) / nb));
  g.K = K;
  g.cwarps = (K * nb + 31) / 32;
  g.seg = kS * nb + 4;
  g.off_ring = 2 * kMaxStages * 8 + ((2 * K * 4 + 15) & ~15);
  const int stage = K * g.seg * 4;
  g.ns = min(kMaxStages, (kSmemMax - g.off_ring) / stage);
  if (g.ns < 2) return (int)cudaErrorInvalidValue;
  const int smem1 = g.off_ring + g.ns * stage;
  // pass 2: the head ring and two re-walk stages of S3 rows
  g.S3 = max(4, (kDeepElems / nb) & ~3);
  const int smem2 = (2 * kHeadStages + 2) * 8 +
                    4 * (kHeadStages * 32 * kHeadWords + 4 * kDeepElems);
  const int smem3 = 4 * 3 * nb;

  cudaStream_t st = (cudaStream_t)stream;
  if (passes & 1) {
    if (smem1 > __atomic_load_n(&opted[dev][0], __ATOMIC_ACQUIRE)) {
      err = cudaFuncSetAttribute(vk_spec_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem1);
      if (err != cudaSuccess) return (int)err;
      __atomic_store_n(&opted[dev][0], smem1, __ATOMIC_RELEASE);
    }
    vk_spec_kernel<<<(g.nchunk + K - 1) / K, (g.cwarps + 1) * 32, smem1,
                     st>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    if (smem2 > __atomic_load_n(&opted[dev][1], __ATOMIC_ACQUIRE)) {
      err = cudaFuncSetAttribute(vk_resolve_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem2);
      if (err != cudaSuccess) return (int)err;
      __atomic_store_n(&opted[dev][1], smem2, __ATOMIC_RELEASE);
    }
    vk_resolve_kernel<<<nb, 64, smem2, st>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    const int blocks =
        (int)min((size_t)8 * nsm, ((size_t)npad * nb / 4 + 255) / 256);
    vk_final_kernel<<<blocks, 256, smem3, st>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
