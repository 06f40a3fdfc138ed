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
// What bounds it on an H100: by bytes, each lane's level planes and grids
// read once and written once (~1 MB for a CIF lane at level 0, well under a
// microsecond at 3.35 TB/s). In practice, as for kernels 4/5, the chain of
// dependent diagonals (39 at CIF level 0) and the dependent metric chain
// inside one block's search set the time, so one stream fills one SM at
// most. Design: the TPU's two ideas kept. (1) The grid runs over the stream
// lanes: one CTA per lane walks that lane's diagonals (barriers between
// diagonals), so a flush of L lanes keeps L SMs busy in one launch, where
// kernels 4/5 run the lanes one after another on one SM. (2) G blocks per
// warp: a block is searched by a tile of 32 / G lanes (Tile<TW>), so the
// tiles of one warp work on G blocks of the diagonal at once; per-block
// sums are segmented shuffle reductions inside the tile, the counterpart of
// the TPU's masked lane sums (gsum :62). The per-lane pointers and scalars
// (each lane has its own planes, quant, skip threshold and bits-to-score
// ratio) are the kernel's parameter block; the rest of the geometry is one
// for all lanes of a launch (lanes of one key share their WaveCfg).

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
};

template <int TW, bool L0>
__global__ void __launch_bounds__(kMaxThreads)
    gang_kernel(const __grid_constant__ GangP P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ G g;
  __shared__ Lv L;
  const LaneP& lp = P.lane[blockIdx.x];
  if (threadIdx.x == 0) {
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
  __syncthreads();
  walk_level<TW, L0>(g, L, lp.sums, smem);
}

template <int TW>
int launch(bool l0, const GangP& P, int nlanes, cudaStream_t st) {
  const int tiles = level_tiles(P.g, TW);
  if (!l0) {
    gang_kernel<TW, false><<<nlanes, TW * tiles, 0, st>>>(P);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)tiles * kHgBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gang_kernel<TW, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gang_kernel<TW, true><<<nlanes, TW * tiles, smem, st>>>(P);
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
// (quant, skip_thresh, b2sr) (host memory). Returns a cudaError_t (0 = ok);
// allocates nothing, does not sync.
extern "C" int dsv2t_hme_gang(int l0, int tw, int nlanes, const int* geom,
                              const long long* ptrs, const int* scal,
                              void* stream) {
  if (nlanes < 1 || nlanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  GangP P;
  int* gp = reinterpret_cast<int*>(&P.g);
  for (int k = 0; k < kGeomLen; ++k) gp[k] = geom[k];
  if (!geometry_ok(P.g)) return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (tw) {
    case 32: return launch<32>(l0 != 0, P, nlanes, st);
    case 16: return launch<16>(l0 != 0, P, nlanes, st);
    case 8: return launch<8>(l0 != 0, P, nlanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
