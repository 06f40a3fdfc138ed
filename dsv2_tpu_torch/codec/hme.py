"""Hierarchical motion estimation dispatch (port of
`dsv2_tpu/codec/hme.py`).

The backend is `enc.hme_backend`, else the `DSV2_HME` environment
variable, else "auto", as in the twin. Every ported backend searches the
whole pyramid on the device holding the encoder's reference chain, and
the device of the tensors picks the implementation:
- "pallas": the hand-written CUDA kernels 4/5 (ops/hme_gpu,
  csrc/hme_search.cu) for CUDA tensors; lockstep key ("hme_pl", cfg),
  the lanes of a flush one after another;
- "gang": the lockstep kernels 6/7 (ops/hme_gang, csrc/hme_gang.cu), one
  launch per pyramid level for every lane of a flush; key ("hme_gang",
  cfg);
- "auto": "pallas".
For CPU tensors both run their plain PyTorch version (ops/hme_wave). The
twin's host search and XLA wave ("host", "wave") are not ported and
raise; any other name raises. (ref: src/hme.c)
"""
import os

UNPORTED = ("the host and wave motion-search backends are not ported "
            "(ROADMAP: the twin's host chain, item 18)")


def resolve_backend(enc):
    """The effective backend for this encoder: "pallas" or "gang"."""
    backend = getattr(enc, "hme_backend", None) or os.environ.get(
        "DSV2_HME", "auto")
    if backend == "auto":
        return "pallas"
    if backend in ("pallas", "gang"):
        return backend
    if backend in ("host", "wave"):
        raise NotImplementedError("hme_backend=%r: %s" % (backend, UNPORTED))
    raise ValueError("unknown hme_backend %r" % (backend,))


def is_device_backend(enc):
    """True when the search runs on the device, so the encoder keeps the
    whole reference chain there: every ported backend (raises for the
    unported ones)."""
    return resolve_backend(enc) in ("pallas", "gang")


def motion_est(enc, d):
    """Search frame d against its reference; fills d.final_mvs and the
    encoder's per-frame statistics."""
    if resolve_backend(enc) == "gang":
        from ..ops import hme_gang
        hme_gang.motion_est(enc, d)
    else:
        from ..ops import hme_gpu
        hme_gpu.motion_est(enc, d)
