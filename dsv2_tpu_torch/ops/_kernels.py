"""Build and load the hand-written CUDA kernels of the port.

Each kernel source under `dsv2_tpu_torch/csrc/` has a plain C interface;
it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `build/torch_kernels/` at first use and loaded with ctypes. The
library's file name carries a hash of the source, the headers of csrc/
and the nvcc flags, so a library built from other sources is never
loaded. Nothing here runs at import time: a CPU-only installation
imports this module freely and never builds.
"""
import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# source name -> (C entry point, argtypes): pointers and the stream as
# c_void_p (ctypes would cut a pointer passed as a plain int), ints c_int
_ENTRY = {"vk_chain": ("dsv2t_vk_chain",
                        [_P] * 5 + [_I] * 6 + [_P, _P]),
          "wavefront_filter": ("dsv2t_wavefront_filter",
                               [_I, _P, _P, _P, _P, _I, _P, _P]),
          "hme_level": ("dsv2t_hme_level", [_P] * 8 + [_I, _P, _P]),
          "hme_level0": ("dsv2t_hme_level0", [_P] * 13 + [_I, _P, _P]),
          "isqrt_check": ("dsv2t_isqrt_check", [_P, _P]),
          "hme_gang": ("dsv2t_hme_gang",
                       [_I, _I, _I, _P, _P, _P, _P, _I, _P]),
          "probe_gang": ("dsv2t_probe_gang",
                         [_I, _I, _P, _P, _P, _P] + [_I] * 6 + [_P])}
# one source may hold several entry points
_SOURCE = {"hme_level": "hme_search", "hme_level0": "hme_search",
           "isqrt_check": "hme_search"}
_GEOM = ("pw", "ph", "tw", "th", "ntx", "nty", "L", "nd", "mr", "mc", "HP",
         "WP", "wh", "ww")
_PLAN = ("R", "C", "J", "LC", "wstride", "rows", "threads", "smem")

_lock = threading.Lock()
_local = threading.local()
_entries = {}
_wavefront_limits = []
build_seconds = {}   # source name -> seconds its last build took


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_key(name):
    """Hash of csrc/<name>.cu, every header of csrc/ and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == name + ".cu" or f.endswith(".cuh"):
            h.update(f.encode())
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def build(name):
    """Path of the shared library for csrc/<name>.cu, built if no library
    of these sources and flags exists (written to a temporary name, then
    renamed, so a concurrent loader never sees a half-written library)."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, _source_key(name)))
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s%s"
                           % (src, res.stdout, res.stderr))
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    return so


def build_all():
    """Build every kernel source at once (one nvcc each, in threads);
    returns {source name: library path}."""
    from concurrent.futures import ThreadPoolExecutor
    names = sorted({_SOURCE.get(n, n) for n in _ENTRY})
    with ThreadPoolExecutor(len(names)) as ex:
        return dict(zip(names, ex.map(build, names)))


def entries(source):
    """The entry point names of csrc/<source>.cu."""
    return [n for n in _ENTRY if _SOURCE.get(n, n) == source]


def entry(name):
    """The C entry point `name` (of csrc/<name>.cu, or of the source
    _SOURCE names; built and loaded on first use); it returns a
    cudaError_t."""
    with _lock:
        if name not in _entries:
            fn_name, argtypes = _ENTRY[name]
            fn = getattr(ctypes.CDLL(build(_SOURCE.get(name, name))),
                         fn_name)
            fn.restype = _I
            fn.argtypes = argtypes
            _entries[name] = fn
        return _entries[name]


VK_MAX_CHAINS = 256   # chains per launch at most


def vk_plan(npad, nb):
    """(rows per chunk, warm-up rows, pass-1 walker threads per block) of
    csrc/vk_chain.cu for nb chains of npad rows. A call of 2^24 rows or
    more (an FHD luma chunk of 16 frames) takes long chunks and warm-ups:
    fewer chunk starts to miss, and their re-walks cost more than the
    longer walk; smaller ones (chroma, one P frame, CIF) short chunks,
    whose walk is most of their time (tools/torch_profile.py --vk sweeps
    the plans)."""
    return ((2048, 512, 128) if npad * min(nb, 16) >= 1 << 24
            else (256, 256, 128))


def vk_scratch_bytes(npad, nb, chunk):
    """Bytes of the scratch csrc/vk_chain.cu takes: a head per chunk and
    chain (nb x nchunk x 64 int32), the decisions (nb x nchunk x 2) and
    the final vk (nb, rounded up to 4)."""
    nchunk = -(-npad // chunk)
    return 4 * (66 * nb * nchunk + (-(-nb // 4)) * 4)


@contextlib.contextmanager
def stand_ins():
    """Yield a list that takes, while the block runs, a stand-in for each
    launch the calling thread makes through vk_chain or wavefront_filter:
    a function that, where this module's attribute of that name is no
    longer the wrapper itself (someone wraps it), calls the attribute
    with the launch's arguments and `replayed` true, so that it launches
    nothing. A CUDA graph captured in the block
    (parallel/dynbatch.GraphedStep) calls them after each replay:
    whoever wraps a launch wrapper then sees each launch that a replay
    makes, as it sees an eager one."""
    prev = getattr(_local, "stand_ins", None)
    made = _local.stand_ins = []
    try:
        yield made
    finally:
        _local.stand_ins = prev


def _stand_in(name, args):
    """Note a stand-in of this launch of wrapper `name`, args() its
    arguments at a replay."""
    made = getattr(_local, "stand_ins", None)
    if made is None:
        return

    def run():
        fn = globals()[name]
        if fn is not _WRAPPERS[name]:
            fn(*args(), replayed=True)
    made.append(run)


def vk_chain(thr, s0, nnz, out, scratch, chunk, warmup, walkers, passes=7,
             stats=None, replayed=False):
    """Launch csrc/vk_chain.cu on the current stream. All arguments are
    contiguous int32 CUDA tensors on one device, checked by the caller
    (ops/scan_pl.vk_chain): thr/out (npad, B) with npad a multiple of 4
    and B <= VK_MAX_CHAINS, s0/nnz (B,); scratch vk_scratch_bytes(npad,
    B, chunk) bytes, 16-byte aligned like thr and out; the plan (chunk,
    warmup, walkers) as vk_plan gives it. `passes` masks the three
    passes (the profiler launches them apart); `stats`, an int32 (5,)
    tensor or None, gets pass 2's counters added (live chunks, chunks
    whose true start met a candidate, chunks re-walked, re-walks that met
    a candidate, rows re-walked). `replayed`: the call stands for a
    launch that a graph's replay made (stand_ins), with s0 and nnz as
    that replay read them; it launches nothing."""
    if replayed:
        return
    import torch
    npad, nb = thr.shape
    with torch.cuda.device(thr.device):
        stream = torch.cuda.current_stream(thr.device).cuda_stream
        rc = entry("vk_chain")(
            thr.data_ptr(), s0.data_ptr(), nnz.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), int(npad), int(nb), int(chunk), int(warmup),
            int(walkers), int(passes),
            None if stats is None else stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("vk_chain launch failed: cudaError %d" % rc)
    # a replay's s0 and nnz, which the next replay writes
    _stand_in("vk_chain", lambda: (thr, s0.clone(), nnz.clone(), out,
                                   scratch, chunk, warmup, walkers, passes,
                                   stats))


def max_smem():
    """The opt-in shared bytes per block the wavefront launch takes on the
    current device (one card per process)."""
    if not _wavefront_limits:
        fn = getattr(ctypes.CDLL(build("wavefront_filter")),
                     "dsv2t_wavefront_limits")
        fn.restype = _I
        fn.argtypes = [ctypes.POINTER(_I)]
        sm = _I(0)
        rc = fn(ctypes.byref(sm))
        if rc != 0:
            raise RuntimeError("wavefront limits query failed: cudaError %d"
                               % rc)
        _wavefront_limits.append(sm.value)
    return _wavefront_limits[0]


def wavefront_geom(lay, nprops, plan):
    """The int32 geometry csrc/wavefront_filter.cu takes: the layout, NP
    and the plan (ops/filters.wavefront_plan; its ring as 0 shared, 1
    global)."""
    return np.array([getattr(lay, k) for k in _GEOM] + [nprops]
                    + [getattr(plan, k) for k in _PLAN]
                    + [int(plan.ring == "global"), plan.scratch],
                    dtype=np.int32)


def wavefront_filter(kind, lay, plane, props, scal, cluster=None,
                     ring=None, replayed=False):
    """Launch csrc/wavefront_filter.cu on the current stream: kind 0/1/2
    (intra/luma/chroma), lay an ops/filters._Lay, plane (B, HP, WP),
    props (B, NP, nty, ntx) and scal (B, 8) contiguous int32 CUDA tensors
    on one device, checked by the caller (ops/filters.wavefront_filter).
    The plan (`cluster` CTAs per plane, or the fewest that fit; the ring
    in `ring` memory, or in shared memory where a plan fits) comes from
    ops/filters.wavefront_plan, which raises on a layout no plan takes.
    A global ring gets a scratch buffer of the plan's bytes per plane.
    The kernel works on a uint8 copy of the plane (its values lie in [0,
    255]), copied back after the launch. Returns the plan. `replayed`:
    the call stands for a launch that a graph's replay made (stand_ins);
    it launches nothing and returns None."""
    if replayed:
        return None
    import torch
    from . import filters
    with torch.cuda.device(plane.device):
        plan = filters.wavefront_plan(lay, cluster, max_smem(), ring)
        geom = wavefront_geom(lay, props.shape[1], plan)
        u8 = plane.to(torch.uint8)
        scratch = None
        if plan.ring == "global":
            scratch = torch.empty(plane.shape[0] * plan.scratch,
                                  dtype=torch.uint8, device=plane.device)
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = entry("wavefront_filter")(
            int(kind), u8.data_ptr(), props.data_ptr(), scal.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            int(plane.shape[0]), geom.ctypes.data, stream)
        if rc != 0:
            raise RuntimeError("wavefront_filter launch failed: cudaError "
                               "%d (%s)" % (rc, plan))
        plane.copy_(u8)
    _stand_in("wavefront_filter", lambda: (kind, lay, plane, props, scal,
                                           cluster, ring))
    return plan


# the launch wrappers whose launches a graph's replay stands in for
_WRAPPERS = {"vk_chain": vk_chain, "wavefront_filter": wavefront_filter}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _run(name, dev, *ptrs):
    import torch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(name)(*ptrs, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, rc))


def hme_level(src, ref, ogr, parent, tmv, gxy, out, sched, geom, workers=0):
    """Launch csrc/hme_search.cu's upper-level search on the current
    stream; tensors checked by the caller (ops/hme_gpu.hme_level), sched
    the scheduler's zeroed scratch, geom an int32 numpy array, workers
    the warps that search blocks (0: the kernel's default)."""
    geom = np.ascontiguousarray(geom, dtype=np.int32)
    _run("hme_level", src.device, *(_ptr(t) for t in (
        src, ref, ogr, parent, tmv, gxy, out, sched)), int(workers),
         ctypes.c_void_p(geom.ctypes.data))


def hme_level0(src, ref, ogr, chroma, parent, tmv, gxy, out, sums, sched,
               geom):
    """Launch csrc/hme_search.cu's base-level search on the current
    stream; tensors checked by the caller (ops/hme_gpu.hme_level0), sched
    the scheduler's zeroed scratch (its workers are the kernel's default;
    tools/torch_profile.py --hme sweeps them through the C entry)."""
    geom = np.ascontiguousarray(geom, dtype=np.int32)
    _run("hme_level0", src.device, *(_ptr(t) for t in (
        (src, ref, ogr) + tuple(chroma) + (parent, tmv, gxy, out, sums,
                                           sched))),
         0, ctypes.c_void_p(geom.ctypes.data))


def isqrt_check(bad):
    """Launch csrc/hme_search.cu's check of the exact square root over all
    2^32 inputs on the current stream; bad: a zeroed int64 CUDA tensor
    (1,) that receives the count of wrong roots."""
    _run("isqrt_check", bad.device, _ptr(bad))


def hme_gang(l0, tw, geom, ptrs, scal, dev, sched, workers=0):
    """Launch csrc/hme_gang.cu for every stream lane of a flush on the
    current stream: l0 picks the base level, tw the lanes per block; geom
    the shared GEOM ints, ptrs (lanes, 12) int64 device pointers, scal
    (lanes, 3) int32 (quant, skip_thresh, b2sr), all host numpy arrays;
    sched the scheduler's zeroed int32 scratch, workers the tiles that
    search blocks (0: the kernel's default); tensors checked by the
    caller (ops/hme_gpu.hme_gang_level[0])."""
    geom = np.ascontiguousarray(geom, dtype=np.int32)
    ptrs = np.ascontiguousarray(ptrs, dtype=np.int64)
    scal = np.ascontiguousarray(scal, dtype=np.int32)
    _run("hme_gang", dev, int(l0), int(tw), len(scal),
         ctypes.c_void_p(geom.ctypes.data), ctypes.c_void_p(ptrs.ctypes.data),
         ctypes.c_void_p(scal.ctypes.data),
         ctypes.c_void_p(sched.data_ptr()), int(workers))


def probe_gang(variant, mode, plane, cx, cy, out, nb, evals, ctas, warps):
    """A launcher of csrc/probe_gang.cu on the current stream: variant
    0/1/2 (block, gang, scalar), mode 0/1/2 (full, read, compute); plane
    (HP, WP) uint8, cx/cy (nb,) int32, out zeroed int32; the block and
    gang probes on `ctas` CTAs of `warps` warps (launch_shape); checked by
    the caller (dsv2_tpu_torch/tools/probe_gang.py). Returns a callable
    that launches the kernel once on the plane's device, which must be
    the current one, with these arguments (bound once, so that a timing
    loop's launches cost one C call each: a warp per block finishes in
    less time than a device switch and a stream lookup take on the host)
    and raises if the launch fails."""
    import torch
    fn = entry("probe_gang")
    hp, wp = plane.shape
    args = (int(variant), int(mode), *(_ptr(t) for t in (plane, cx, cy, out)),
            int(nb), int(evals), int(hp), int(wp), int(ctas), int(warps),
            ctypes.c_void_p(torch.cuda.current_stream(
                plane.device).cuda_stream))

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError("probe_gang launch failed: cudaError %d" % rc)
    return launch
