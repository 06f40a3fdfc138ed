"""Hierarchical motion estimation dispatch (port of
`dsv2_tpu/codec/hme.py`).

One backend: the whole pyramid search on the device holding the
encoder's reference chain (ops/hme_gpu). The device of the tensors picks
the implementation: the hand-written CUDA kernels (csrc/hme_search.cu)
for CUDA tensors, their plain PyTorch version (ops/hme_wave) for CPU
tensors. The twin's other backends (host search, XLA wave, gang
kernels) are not ported: an explicit `enc.hme_backend` other than None
or "auto" raises. (ref: src/hme.c)
"""
from ..ops import hme_gpu, hme_wave

UNPORTED = ("the host and gang motion-search backends are not ported "
            "(ROADMAP: kernels 6/7)")


def resolve_backend(enc):
    backend = getattr(enc, "hme_backend", None)
    if backend not in (None, "auto"):
        raise NotImplementedError("hme_backend=%r: %s" % (backend, UNPORTED))
    return "device"


def motion_est(enc, d):
    """Search frame d against its reference; fills d.final_mvs and the
    encoder's per-frame statistics."""
    resolve_backend(enc)
    cfg, inputs = hme_wave.prepare_motion_est(enc, d)
    hme_wave.apply_motion_est(enc, d, hme_gpu.make_motion_est(cfg)(*inputs))
