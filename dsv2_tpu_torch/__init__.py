"""dsv2_tpu_torch — the DSV2 (bitstream v2.8) codec on PyTorch: intra and
P encode, decode.

The port of `dsv2_tpu` to PyTorch and CUDA. Device compute (subband
transforms, quantization, HVS block analysis, the entropy-coded scan
blob, motion compensation) runs as integer torch ops on int32 tensors;
the sequential recurrences, which the TPU ran as Pallas kernels, are
hand-written CUDA kernels under `csrc/`: the rice vk adaptation chain,
the in-loop filter wavefront and the motion search. Host code (sessions, rate control, packetization,
the native C runtime) is the port's own copy of `dsv2_tpu`'s host
modules, under the same paths. This package imports neither jax nor
anything of `dsv2_tpu`.

Module names mirror `dsv2_tpu`: `ops/sbt.py` here is the port of
`dsv2_tpu/ops/sbt.py`, and so on.
"""
import os

import torch

__version__ = "0.1.0"

DEVICE_ENV = "DSV2_TORCH_DEVICE"


def default_device():
    """The device named by DSV2_TORCH_DEVICE (`cuda` or `cpu`, default
    `cuda`). Asking for CUDA where there is none raises: the CPU is used
    only when it was asked for."""
    name = os.environ.get(DEVICE_ENV, "cuda") or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError("%s must be 'cuda' or 'cpu', not %r"
                         % (DEVICE_ENV, name))
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; set %s=cpu to run on the CPU"
            % DEVICE_ENV)
    return torch.device(name)
