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
// What bounds it on an H100: by bytes, the level's planes and grids read
// once and written once (~12 MB at FHD level 0, ~4 us at 3.35 TB/s); by
// operations, ~26 candidate metrics of ~30 integer operations per quad per
// block. In practice the chain of dependent diagonals sets the time (187
// at FHD level 0), and inside a diagonal one block's search, whose
// candidate metrics, refine probes and decisions depend on each other.
// Design: one CTA per level, a loop over the diagonals inside the CTA in
// place of the TPU's sequential grid (a barrier between diagonals). A warp
// searches one block (Tile<32>): its 32 lanes run the block's control flow
// in step and split every pixel or quad loop between them, with shuffle
// reductions; a CTA has up to 16 warps (a thread keeps 128 registers),
// which take the blocks of a diagonal in turn. Each warp reads its
// neighbours, parents and temporal candidates from the grids itself (the
// TPU's pre-gathered candidate pack and SMEM ring are gone) and lane 0
// writes the results into the grids.

#include "hme_block.cuh"

namespace {

template <bool L0>
__global__ void __launch_bounds__(kMaxThreads) hme_kernel(G g, Lv L,
                                                         int* sums) {
  extern __shared__ __align__(16) uint8_t smem[];
  walk_level<32, L0>(g, L, sums, smem);
}

int launch(bool l0, const int* geom, Lv L, int* sums, void* stream) {
  G g;
  int* gp = reinterpret_cast<int*>(&g);
  for (int k = 0; k < kGeomLen; ++k) gp[k] = geom[k];
  if (!geometry_ok(g)) return (int)cudaErrorInvalidValue;
  const int warps = level_tiles(g, 32);
  L.src.W = L.ref.W = L.ogr.W = g.W;
  L.src.H = L.ref.H = L.ogr.H = g.H;
  L.su.W = L.sv.W = L.ru.W = L.rv.W = g.CW;
  L.su.H = L.sv.H = L.ru.H = L.rv.H = g.CH;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)warps * kHgBytes;
  if (l0)
    hme_kernel<true><<<1, 32 * warps, smem, st>>>(g, L, sums);
  else
    hme_kernel<false><<<1, 32 * warps, 0, st>>>(g, L, sums);
  return (int)cudaGetLastError();
}

}  // namespace

// One upper pyramid level (kernel 4) on `stream`: fills out (2, nbv, nbh)
// (zeroed by the caller) with fx, fy. geom: the GEOM ints of
// ops/hme_gpu.py. Returns cudaGetLastError() (0 = ok); allocates nothing,
// does not sync.
extern "C" int dsv2t_hme_level(const uint8_t* src, const uint8_t* ref,
                               const uint8_t* ogr, const int* parent,
                               const int* tmv, const int* gxy, int* out,
                               const int* geom, void* stream) {
  Lv L = {};
  L.src.p = src;
  L.ref.p = ref;
  L.ogr.p = ogr;
  L.parent = parent;
  L.tmv = tmv;
  L.gxy = gxy;
  L.out = out;
  return launch(false, geom, L, nullptr, stream);
}

// The base level (kernel 5): fills out (7, nbv, nbh) (zeroed by the
// caller) with fx, fy, flags, err, dc, submask, fskip and adds the frame
// sums terr, ndiff, nelig, nintra to sums (4,) (zeroed by the caller).
extern "C" int dsv2t_hme_level0(const uint8_t* src, const uint8_t* ref,
                                const uint8_t* ogr, const uint8_t* su,
                                const uint8_t* sv, const uint8_t* ru,
                                const uint8_t* rv, const int* parent,
                                const int* tmv, const int* gxy, int* out,
                                int* sums, const int* geom, void* stream) {
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
  return launch(true, geom, L, sums, stream);
}
