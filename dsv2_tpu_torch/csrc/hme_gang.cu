// The encoder's motion search for every stream lane of a lockstep flush,
// for Hopper: one launch per pyramid level covers all lanes.
//
// Replaces the TPU kernels dsv2_tpu/ops/hme_gang.py::_level_call (:1057,
// one upper pyramid level) and ::_level0_call (:1139, the base level with
// the subpel refine and the mode decisions), which pack G blocks of one
// anti-diagonal side by side on the 128-lane vector rows (:1063) and, under
// lockstep, get a lane axis in their grid from vmap
// (dsv2_tpu/parallel/dynbatch.py:275). They compute what kernels 4/5
// compute, field for field; the per-block search is csrc/hme_block.cuh,
// the code kernels 4/5 (csrc/hme_search.cu) run.
//
// What bounds it on an H100: not bytes (each lane's level planes and grids
// read once and written once, ~1 MB for a CIF lane at level 0, well under
// a microsecond at 3.35 TB/s), but the dependency depth of a level (39
// anti-diagonals at CIF level 0, 19 at level 1) times the part of one
// block's search that needs its neighbours, a chain of dependent metrics,
// reductions and decisions.
// Design. Every level runs on the whole card: the blocks of every lane are
// claimed in the topological order of csrc/hme_sched.cuh (diagonal, lane,
// position), so a worker takes any lane's block, and a block starts once
// its left and top neighbours of its own lane are published; each block's
// search is split around that wait (hme_block.cuh; an upper level's blocks
// sit at multiples of its step, upper_dag). The TPU's grid over the
// stream lanes becomes that one scheduler over every lane's blocks, and
// its G blocks per warp stay: a block is searched by a tile of 32 / G
// lanes (Tile<TW>), per-block sums being segmented shuffle reductions
// inside the tile, the counterpart of the TPU's masked lane sums (gsum
// :62). The
// per-lane pointers and scalars (each lane has its own planes, quant, skip
// threshold and bits-to-score ratio) are the kernel's parameter block; the
// rest of the geometry is one for all lanes of a launch (lanes of one key
// share their WaveCfg).

#include "hme_block.cuh"

namespace {

constexpr int kMaxLanes = 32;  // keeps GangP inside the 4 KB of parameters
constexpr int kLanePtrs = 12;

struct LaneP {
  const uint8_t* p[7];  // src, ref, ogr, src_u, src_v, ref_u, ref_v
  const int* parent;    // (2, nbv, nbh)
  const int* tmv;       // (2, nbv, nbh)
  const int* gxy;       // (2,)
  int* out;             // (NF, nbv, nbh)
  int* sums;            // (4,) at level 0
  int quant, skip_thresh, b2sr;
};

struct GangP {
  G g;  // quant, skip_thresh and b2sr come from the lane
  LaneP lane[kMaxLanes];
  Dag dag;  // the lanes' blocks and the scheduler's scratch
};

// the geometry and planes of stream lane n
__device__ void lane_view(const GangP& P, int n, G& g, Lv& L) {
  const LaneP& lp = P.lane[n];
  g = P.g;
  g.quant = lp.quant;
  g.skip_thresh = lp.skip_thresh;
  g.b2sr = lp.b2sr;
  Plane* pl[7] = {&L.src, &L.ref, &L.ogr, &L.su, &L.sv, &L.ru, &L.rv};
  for (int k = 0; k < 7; ++k) {
    pl[k]->p = lp.p[k];
    pl[k]->W = k < 3 ? g.W : g.CW;
    pl[k]->H = k < 3 ? g.H : g.CH;
  }
  L.parent = lp.parent;
  L.tmv = lp.tmv;
  L.gxy = lp.gxy;
  L.out = lp.out;
}

template <int TW>
__global__ void __launch_bounds__(kDagThreads)
    gang_level_kernel(const __grid_constant__ GangP P) {
  extern __shared__ __align__(16) uint8_t smem[];
  upper_dag<TW>(P.dag, smem,
                [&](int n, G& g, Lv& L) { lane_view(P, n, g, L); });
}

template <int TW>
__global__ void __launch_bounds__(kDagThreads)
    gang_level0_kernel(const __grid_constant__ GangP P) {
  extern __shared__ __align__(16) uint8_t smem[];
  level0_dag<TW>(P.dag, smem, [&](int n, G& g, Lv& L, int*& sums) {
    lane_view(P, n, g, L);
    sums = P.lane[n].sums;
  });
}

template <class K>
cudaError_t fit_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int TW>
int launch(bool l0, const GangP& P, int nlanes, int workers, cudaStream_t st) {
  int threads;
  if (!l0) {
    const int ctas = dag_shape(nlanes * P.dag.nbh * P.dag.nbv, TW, workers,
                               &threads);
    const size_t smem = (size_t)(threads / TW) * kUpperTileBytes;
    const cudaError_t e = fit_smem(gang_level_kernel<TW>, smem);
    if (e != cudaSuccess) return (int)e;
    gang_level_kernel<TW><<<ctas, threads, smem, st>>>(P);
    return (int)cudaGetLastError();
  }
  const int ctas = dag_shape(nlanes * P.g.nbh * P.g.nbv, TW, workers,
                             &threads);
  const size_t smem = (size_t)(threads / TW) * kTileBytes;
  const cudaError_t e = fit_smem(gang_level0_kernel<TW>, smem);
  if (e != cudaSuccess) return (int)e;
  gang_level0_kernel<TW><<<ctas, threads, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// One pyramid level of `nlanes` stream lanes on `stream`: kernel 6 (an
// upper level: fills each lane's out (2, nbv, nbh) with fx, fy) or, with
// l0, kernel 7 (the base level: fills out (7, nbv, nbh) with fx, fy, flags,
// err, dc, submask, fskip and adds terr, ndiff, nelig, nintra to sums (4,)).
// Outputs and sums are zeroed by the caller. tw: lanes per block (32, 16 or
// 8: 1, 2 or 4 blocks per warp). geom: the GEOM ints of ops/hme_gpu.py,
// shared by the lanes; ptrs: nlanes rows of the 12 LaneP pointers (host
// memory; null where a level has no such input); scal: nlanes rows of
// (quant, skip_thresh, b2sr) (host memory). sched: the scheduler's scratch
// of 1 + nlanes * ca * cb int32 zeroed by the caller (ca x cb: the
// level's blocks, nbh x nbv at level 0, the block grid at a step of
// 2^level above); workers: the tiles that search blocks (0: 2 warps on
// every SM).
// Returns a cudaError_t (0 = ok); allocates nothing, does not sync.
extern "C" int dsv2t_hme_gang(int l0, int tw, int nlanes, const int* geom,
                              const long long* ptrs, const int* scal,
                              int* sched, int workers, void* stream) {
  if (nlanes < 1 || nlanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  GangP P;
  int* gp = reinterpret_cast<int*>(&P.g);
  for (int k = 0; k < kGeomLen; ++k) gp[k] = geom[k];
  if (!geometry_ok(P.g)) return (int)cudaErrorInvalidValue;
  if (sched == nullptr) return (int)cudaErrorInvalidValue;
  for (int n = 0; n < nlanes; ++n) {
    const long long* r = ptrs + n * kLanePtrs;
    LaneP& lp = P.lane[n];
    for (int k = 0; k < 7; ++k) lp.p[k] = reinterpret_cast<const uint8_t*>(r[k]);
    lp.parent = reinterpret_cast<const int*>(r[7]);
    lp.tmv = reinterpret_cast<const int*>(r[8]);
    lp.gxy = reinterpret_cast<const int*>(r[9]);
    lp.out = reinterpret_cast<int*>(r[10]);
    lp.sums = reinterpret_cast<int*>(r[11]);
    lp.quant = scal[3 * n];
    lp.skip_thresh = scal[3 * n + 1];
    lp.b2sr = scal[3 * n + 2];
  }
  P.dag = l0 ? Dag{P.g.nbh, P.g.nbv, nlanes, sched, sched + 1}
             : upper_dag_of(P.g, nlanes, sched);
  cudaStream_t st = (cudaStream_t)stream;
  switch (tw) {
    case 32: return launch<32>(l0 != 0, P, nlanes, workers, st);
    case 16: return launch<16>(l0 != 0, P, nlanes, workers, st);
    case 8: return launch<8>(l0 != 0, P, nlanes, workers, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
