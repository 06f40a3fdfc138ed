"""Build and load the hand-written CUDA kernels of the port.

Each kernel source under `dsv2_tpu_torch/csrc/` has a plain C interface;
it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `build/torch_kernels/` at first use — and again whenever the
source is newer than the library — and loaded with ctypes. Nothing here
runs at import time: a CPU-only installation imports this module freely
and never builds.
"""
import ctypes
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# source name -> (C entry point, argtypes): pointers and the stream as
# c_void_p (ctypes would cut a pointer passed as a plain int), ints c_int
_ENTRY = {"vk_chain": ("dsv2t_vk_chain", [_P, _P, _P, _P, _P, _I, _I, _P]),
          "wavefront_filter": ("dsv2t_wavefront_filter",
                               [_I, _P, _P, _P, _I, _P, _P])}
_GEOM = ("pw", "ph", "tw", "th", "ntx", "nty", "L", "nd", "mr", "mc", "HP",
         "WP", "wh", "ww")

_lock = threading.Lock()
_entries = {}
_wavefront_limits = []
build_seconds = {}   # source name -> seconds its last build took


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name):
    """Path of the shared library for csrc/<name>.cu, built if missing or
    older than its source (written to a temporary name, then renamed, so
    a concurrent loader never sees a half-written library)."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, "lib%s.so" % name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
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


def entry(name):
    """The C entry point of csrc/<name>.cu (built and loaded on first
    use); it returns a cudaError_t."""
    with _lock:
        if name not in _entries:
            fn_name, argtypes = _ENTRY[name]
            fn = getattr(ctypes.CDLL(build(name)), fn_name)
            fn.restype = _I
            fn.argtypes = argtypes
            _entries[name] = fn
        return _entries[name]


def vk_chain(thr, s0, nnz, out, vkend):
    """Launch csrc/vk_chain.cu on the current stream. All arguments are
    contiguous int32 CUDA tensors on one device, checked by the caller
    (ops/scan_pl.vk_chain): thr/out (npad, B), s0/nnz/vkend (B,)."""
    import torch
    npad, nb = thr.shape
    with torch.cuda.device(thr.device):
        stream = torch.cuda.current_stream(thr.device).cuda_stream
        rc = entry("vk_chain")(
            thr.data_ptr(), s0.data_ptr(), nnz.data_ptr(), out.data_ptr(),
            vkend.data_ptr(), int(npad), int(nb), stream)
    if rc != 0:
        raise RuntimeError("vk_chain launch failed: cudaError %d" % rc)


def _limits():
    """(max threads, max opt-in shared bytes per block) the wavefront
    launch takes on the current device (one card per process)."""
    if not _wavefront_limits:
        fn = getattr(ctypes.CDLL(build("wavefront_filter")),
                     "dsv2t_wavefront_limits")
        fn.restype = _I
        fn.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
        nt, sm = _I(0), _I(0)
        rc = fn(ctypes.byref(nt), ctypes.byref(sm))
        if rc != 0:
            raise RuntimeError("wavefront limits query failed: cudaError %d"
                               % rc)
        _wavefront_limits.append((nt.value, sm.value))
    return _wavefront_limits[0]


def wavefront_filter(kind, lay, plane, props, scal):
    """Launch csrc/wavefront_filter.cu on the current stream: kind 0/1/2
    (intra/luma/chroma), lay an ops/filters._Lay, plane (B, HP, WP),
    props (B, NP, nty, ntx) and scal (B, 8) contiguous int32 CUDA tensors
    on one device, checked by the caller (ops/filters.wavefront_filter).
    Raises on a layout the kernel does not take."""
    import numpy as np
    import torch
    with torch.cuda.device(plane.device):
        max_threads, max_smem = _limits()
        threads = -(-lay.L // 32) * 32
        smem = lay.L * ((lay.wh * lay.ww) | 1) * 4
        if threads > max_threads or smem > max_smem:
            raise ValueError(
                "wavefront layout too large for the kernel: %d lanes of "
                "%dx%d windows need %d threads and %d B of shared memory "
                "(limits %d, %d)" % (lay.L, lay.wh, lay.ww, threads, smem,
                                     max_threads, max_smem))
        geom = np.array([getattr(lay, k) for k in _GEOM]
                        + [props.shape[1]], dtype=np.int32)
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = entry("wavefront_filter")(
            int(kind), plane.data_ptr(), props.data_ptr(), scal.data_ptr(),
            int(plane.shape[0]), geom.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError("wavefront_filter launch failed: cudaError %d"
                           % rc)
