// The encoder's motion search (hierarchical, wavefront over anti-diagonals)
// for Hopper: one stream.
//
// Replaces the TPU kernels dsv2_tpu/ops/hme_pallas.py::_level_call (:248,
// one upper pyramid level: candidate search + greedy refine) and
// ::_level0_call (:311, the base level: the same search, subpel refine, the
// skip / no-residual / EPRM decisions, the luma and chroma intra subblock
// tests and the flag assembly). The per-block search, its semantics and
// layout are in csrc/hme_block.cuh (shared with the lockstep kernels of
// csrc/hme_gang.cu).
//
// What bounds it on an H100: not bytes (the level's planes and grids read
// once and written once: ~12 MB at FHD level 0, 0.0029 ms at 3.35 TB/s),
// but the dependency depth of a level, its number of anti-diagonals (187
// at FHD level 0; 93 at FHD level 1, 60 x 34 blocks at a step of 2),
// times the part of one block's search that needs its neighbours, a chain
// of dependent metrics, reductions and decisions.
// Design. Every level runs on the whole card: its blocks are claimed by
// warps of CTAs on every SM in the topological order of csrc/hme_sched.cuh,
// and each block starts as soon as its left and top neighbours have
// published their fields, with no barrier between diagonals. Each block's
// search is split around that wait (hme_block.cuh): the source window, the
// features, the candidates that are not a neighbour's vector and the
// good-enough metric run before it, the neighbours' candidates, the pick
// and the refine after (and the decisions, at the base level); inside a
// block, independent metrics share one pass and their reductions
// interleave. A warp searches one block (Tile<32>), its lanes splitting
// every pixel or quad loop, and reads its neighbours, parents and temporal
// candidates from the grids itself (the TPU's pre-gathered candidate pack
// and SMEM ring are gone); lane 0 writes the results into the grids.

#include "hme_block.cuh"

namespace {

__global__ void __launch_bounds__(kDagThreads)
    hme_level_kernel(G g, Lv L, Dag dag) {
  extern __shared__ __align__(16) uint8_t smem[];
  upper_dag<32>(dag, smem, [&](int, G& gl, Lv& Ll) {
    gl = g;
    Ll = L;
  });
}

__global__ void __launch_bounds__(kDagThreads)
    hme_level0_kernel(G g, Lv L, int* sums, Dag dag) {
  extern __shared__ __align__(16) uint8_t smem[];
  level0_dag<32>(dag, smem, [&](int, G& gl, Lv& Ll, int*& s) {
    gl = g;
    Ll = L;
    s = sums;
  });
}

int launch(bool l0, const int* geom, Lv L, int* sums, int* sched, int workers,
           void* stream) {
  G g;
  int* gp = reinterpret_cast<int*>(&g);
  for (int k = 0; k < kGeomLen; ++k) gp[k] = geom[k];
  if (!geometry_ok(g)) return (int)cudaErrorInvalidValue;
  L.src.W = L.ref.W = L.ogr.W = g.W;
  L.src.H = L.ref.H = L.ogr.H = g.H;
  L.su.W = L.sv.W = L.ru.W = L.rv.W = g.CW;
  L.su.H = L.sv.H = L.ru.H = L.rv.H = g.CH;
  cudaStream_t st = (cudaStream_t)stream;
  if (sched == nullptr) return (int)cudaErrorInvalidValue;
  int threads;
  if (!l0) {
    const Dag dag = upper_dag_of(g, 1, sched);
    const int ctas = dag_shape(dag.nbh * dag.nbv, 32, workers, &threads);
    hme_level_kernel<<<ctas, threads, (threads / 32) * kUpperTileBytes, st>>>(
        g, L, dag);
    return (int)cudaGetLastError();
  }
  const Dag dag{g.nbh, g.nbv, 1, sched, sched + 1};
  const int ctas = dag_shape(g.nbh * g.nbv, 32, workers, &threads);
  hme_level0_kernel<<<ctas, threads, (threads / 32) * kTileBytes, st>>>(
      g, L, sums, dag);
  return (int)cudaGetLastError();
}

}  // namespace

// One upper pyramid level (kernel 4) on `stream`: fills out (2, nbv, nbh)
// (zeroed by the caller) with fx, fy. sched: the scheduler's scratch, 1 +
// ca * cb int32 zeroed by the caller (ca x cb: the level's blocks, the
// block grid at a step of 2^level); workers: the warps that search blocks
// (0: 2 on every SM). geom: the GEOM ints of ops/hme_gpu.py. Returns
// cudaGetLastError() (0 = ok); allocates nothing, does not sync.
extern "C" int dsv2t_hme_level(const uint8_t* src, const uint8_t* ref,
                               const uint8_t* ogr, const int* parent,
                               const int* tmv, const int* gxy, int* out,
                               int* sched, int workers, const int* geom,
                               void* stream) {
  Lv L = {};
  L.src.p = src;
  L.ref.p = ref;
  L.ogr.p = ogr;
  L.parent = parent;
  L.tmv = tmv;
  L.gxy = gxy;
  L.out = out;
  return launch(false, geom, L, nullptr, sched, workers, stream);
}

// The base level (kernel 5): fills out (7, nbv, nbh) (zeroed by the
// caller) with fx, fy, flags, err, dc, submask, fskip and adds the frame
// sums terr, ndiff, nelig, nintra to sums (4,) (zeroed by the caller).
// sched: the scheduler's scratch, 1 + nbv * nbh int32 zeroed by the
// caller; workers: the warps that search blocks (0: 2 on every SM).
extern "C" int dsv2t_hme_level0(const uint8_t* src, const uint8_t* ref,
                                const uint8_t* ogr, const uint8_t* su,
                                const uint8_t* sv, const uint8_t* ru,
                                const uint8_t* rv, const int* parent,
                                const int* tmv, const int* gxy, int* out,
                                int* sums, int* sched, int workers,
                                const int* geom, void* stream) {
  Lv L = {};
  L.src.p = src;
  L.ref.p = ref;
  L.ogr.p = ogr;
  L.su.p = su;
  L.sv.p = sv;
  L.ru.p = ru;
  L.rv.p = rv;
  L.parent = parent;
  L.tmv = tmv;
  L.gxy = gxy;
  L.out = out;
  return launch(true, geom, L, sums, sched, workers, stream);
}

namespace {

__global__ void isqrt_check_kernel(unsigned long long* bad) {
  unsigned long long n_bad = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long n = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       n < (1ull << 32); n += step) {
    const unsigned long long r = isqrt_u32((unsigned)n);
    n_bad += !(r * r <= n && (r + 1) * (r + 1) > n);
  }
  if (n_bad) atomicAdd(bad, n_bad);
}

}  // namespace

// The exact-square-root check of the card tests: adds to *bad (zeroed by
// the caller) the uint32 values n whose isqrt_u32 (csrc/hme_block.cuh) is
// not floor(sqrt(n)), over all 2^32 of them.
extern "C" int dsv2t_isqrt_check(unsigned long long* bad, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  isqrt_check_kernel<<<8 * sms, 256, 0, (cudaStream_t)stream>>>(bad);
  return (int)cudaGetLastError();
}
