// A dataflow scheduler for every pyramid level of the encoder's motion
// search (kernels 4-7: csrc/hme_search.cu, csrc/hme_gang.cu), templated on
// the block body.
//
// What bounds these kernels on an H100: a block depends on its left, top
// and top-left neighbours of the same level (at the base level the median
// predictor, the spatial candidates and the neighbour difference read
// their fields; at an upper level, whose blocks sit at multiples of its
// step, the spatial candidates), so a level is a DAG whose depth is its
// number of anti-diagonals: 187 at FHD level 0 (120 x 68 blocks of
// 16x16), 93 at FHD level 1 (60 x 34), 39 at CIF level 0 (22 x 18). The
// time is that depth times the post-wait part of one block's search, a
// chain of dependent metrics, reductions and decisions of some
// microseconds. By bytes, the level's planes and grids read once and
// written once, the bound is 0.0029 ms at FHD level 0 and says little
// here.
//
// What the design does about it: the blocks of every stream lane of the
// launch go to workers (tiles of TW threads, csrc/hme_block.cuh Tile<TW>)
// spread over every SM of the card, instead of one CTA walking the
// diagonals with a barrier after each; and a block starts as soon as its
// own two neighbours are done, not when the slowest block of the diagonal
// before it is.
//
// - Claiming: a worker takes its next block with an atomicAdd on a ticket
//   counter, never from blockIdx (CTAs start in no fixed order).
// - Ticket order: topological, diagonal first, then stream lane, then the
//   position within the diagonal. A worker waits only on blocks of the
//   diagonal before its own, whose tickets are smaller, so they were
//   claimed by workers that are already running and that themselves wait
//   only on smaller tickets; the smallest unfinished ticket never waits.
//   So no launch deadlocks, whatever the number of workers and whether or
//   not all CTAs are resident at once, with no cooperative launch.
// - Readiness: after the body, whose fields lane 0 of the tile writes,
//   lane 0 publishes the block's ready flag with release semantics. Lane
//   0 of a block waits for its left (i-1, j) and top (i, j-1) neighbours'
//   flags with relaxed loads and __nanosleep backoff, then one acquire
//   fence, and a barrier of the tile orders its other lanes after it (so
//   the many waiting warps poll without acquiring); the top-left block is published before its
//   right neighbour starts (its left one), so it is visible through the
//   left flag. The body reads the neighbours' fields through L2
//   (__ldcg).
// - Scratch: the ticket and the flags are one int32 buffer the wrapper
//   zeroes before the launch: [ticket, ready[lanes][nbv][nbh]] (an upper
//   level's DAG is its ca x cb blocks: nbh = ca, nbv = cb).
//
// The header compiles on the host too (tests/test_torch_hme_sched.py
// builds it against a CUDA shim in which each CUDA thread is an OS thread
// and cuda::atomic_ref is std::atomic_ref).
#pragma once

#include <cuda/atomic>

namespace {

// the blocks of one launch: `lanes` stream lanes of nbv x nbh DAG nodes
struct Dag {
  int nbh, nbv, lanes;
  int* ticket;  // (1,), zeroed by the wrapper
  int* ready;   // (lanes, nbv, nbh), zeroed by the wrapper
};

__device__ __forceinline__ int diag_first(const Dag& g, int d) {
  return max(0, d - (g.nbv - 1));
}
__device__ __forceinline__ int diag_len(const Dag& g, int d) {
  return min(d, g.nbh - 1) - diag_first(g, d) + 1;
}

__device__ __forceinline__ void wait_ready(int* flag) {
  cuda::atomic_ref<int, cuda::thread_scope_device> f(*flag);
  for (unsigned ns = 32; !f.load(cuda::memory_order_relaxed);
       ns = min(2 * ns, 256u))
    __nanosleep(ns);
}

__device__ __forceinline__ void publish(int* flag) {
  cuda::atomic_ref<int, cuda::thread_scope_device>(*flag).store(
      1, cuda::memory_order_release);
}

// Runs body(lane, i, j, wait) once for every block of the DAG. The body
// calls wait() once, tile-uniform; wait returns once the bodies of the
// block's left and top neighbours (same lane) have returned, so the body
// does before it what needs no neighbour and after it the rest. Called by
// every thread of every worker tile; T gives the tile's lane(), bcast0()
// (lane 0's value to the tile) and tile_sync(); lane 0 writes the body's
// results.
template <class T, class Body>
__device__ void run_dag(const Dag& g, Body&& body) {
  const int total = g.lanes * g.nbv * g.nbh;
  int d = 0, base = 0;  // this worker's diagonal and its first ticket
  for (;;) {
    int t = 0;
    if (T::lane() == 0) t = atomicAdd(g.ticket, 1);
    t = T::bcast0(t);
    if (t >= total) return;
    // a worker's tickets only grow, so its cursor only moves forward
    for (int n; t >= base + (n = g.lanes * diag_len(g, d)); ++d) base += n;
    const int len = diag_len(g, d), r = t - base;
    const int lane = r / len, i = diag_first(g, d) + r % len, j = d - i;
    int* ready = g.ready + lane * g.nbv * g.nbh;
    body(lane, i, j, [&] {
      if (T::lane() == 0 && (i > 0 || j > 0)) {
        if (i > 0) wait_ready(ready + j * g.nbh + i - 1);
        if (j > 0) wait_ready(ready + (j - 1) * g.nbh + i);
        cuda::atomic_thread_fence(cuda::memory_order_acquire,
                                  cuda::thread_scope_device);
      }
      T::tile_sync();
    });
    if (T::lane() == 0) publish(ready + j * g.nbh + i);
  }
}

}  // namespace
