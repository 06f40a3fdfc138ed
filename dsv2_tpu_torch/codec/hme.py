"""Hierarchical motion estimation dispatch (port of
`dsv2_tpu/codec/hme.py`).

The backend is `enc.hme_backend`, else the `DSV2_HME` environment
variable, else "auto", as in the twin. Every backend searches the whole
pyramid on the device holding the encoder's reference chain, and the
device of the tensors picks the implementation:
- "pallas": the hand-written CUDA kernels 4/5 (ops/hme_gpu,
  csrc/hme_search.cu) for CUDA tensors; lockstep key ("hme_pl", cfg),
  the lanes of a flush one after another;
- "gang": the lockstep kernels 6/7 (ops/hme_gang, csrc/hme_gang.cu), one
  launch per pyramid level for every lane of a flush; key ("hme_gang",
  cfg);
- "auto", "host" and "wave": "pallas". The twin's backends all give the
  same stream (its host search is its bit-exactness oracle, its wave an
  XLA program of the whole pyramid); the port's one whole-pyramid search
  is the kernel pair.
For CPU tensors both run their plain PyTorch version (ops/hme_wave). Any
other name raises. (ref: src/hme.c)
"""
import os


def resolve_backend(enc):
    """The effective backend for this encoder: "pallas" or "gang"."""
    backend = getattr(enc, "hme_backend", None) or os.environ.get(
        "DSV2_HME", "auto")
    if backend in ("auto", "host", "wave"):
        return "pallas"
    if backend in ("pallas", "gang"):
        return backend
    raise ValueError("unknown hme_backend %r" % (backend,))


def motion_est(enc, d):
    """Search frame d against its reference; fills d.final_mvs and the
    encoder's per-frame statistics."""
    if resolve_backend(enc) == "gang":
        from ..ops import hme_gang
        hme_gang.motion_est(enc, d)
    else:
        from ..ops import hme_gpu
        hme_gpu.motion_est(enc, d)
