"""Bytes of the rice vk adaptation chain (kernel 1, csrc/vk_chain.cu),
counted from what the algorithm needs, whatever implements it.

A call takes thr (npad, B) int32, time-major, and s0, nnz (B,) int32;
it gives vkpre (npad, B) int32. Chain b walks rows [s0_b, nnz_b) in
order, storing the vk before each update; every other row of its
column is defined without reading thr (0 below s0, the final vk from
nnz on). So the least traffic is:

    read   4 * sum_b (clip(nnz_b) - clip(s0_b))   the rows walked
         + 8 * B                                   s0 and nnz
    write  4 * npad * B                            vkpre, every row

(clip to [0, npad], a chain's walk never negative). Hand count at
npad = 8, B = 2, s0 = (0, 2), nnz = (5, 8): 4 * (5 + 6) + 16 + 64 = 124
bytes (codecbench/tests/test_codecbench_rooflines.py).
"""
import re

import numpy as np

# the launch wrapper whose calls are counted: _kernels.vk_chain(thr, s0,
# nnz, out, scratch, chunk, warmup, walkers, ...)
TARGET = ("dsv2_tpu_torch.ops._kernels", "vk_chain")
# the kernels of one call (three passes)
KERNEL = re.compile(r"\bvk_(spec|resolve|final)_kernel\b")


def record(thr, s0, nnz, *args, **kwargs):
    """What a call's bytes depend on; s0 and nnz are read after the
    profiled job, so recording costs no copy inside it."""
    return int(thr.shape[0]), int(thr.shape[1]), s0, nnz


def nbytes(call):
    npad, nb, s0, nnz = call
    lo = np.clip(np.asarray(s0.cpu(), dtype=np.int64), 0, npad)
    hi = np.maximum(np.clip(np.asarray(nnz.cpu(), dtype=np.int64), 0,
                            npad), lo)
    return int(4 * (hi - lo).sum() + 8 * nb + 4 * npad * nb)
