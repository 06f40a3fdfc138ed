"""Parity helpers for the torch port's tests (tests/test_torch_*.py).

The same numpy input goes through a `dsv2_tpu` function (JAX on the CPU)
and its `dsv2_tpu_torch` counterpart; the outputs must agree bit for bit,
dtype included. Every value on the ported path is an integer, so no
tolerance applies.
"""
import os
import sys

import numpy as np
import torch

os.environ.setdefault("DSV2_TORCH_DEVICE", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))  # torch_port_golden


def to_np(x):
    """jax array, torch tensor or numpy array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what="output"):
    """Bit-exact equality, dtype included, recursing into tuples/lists."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "%s[%d]" % (what, i))
        return
    g, w = to_np(got), to_np(want)
    assert g.dtype == w.dtype, "%s dtype %s != %s" % (what, g.dtype, w.dtype)
    assert g.shape == w.shape, "%s shape %s != %s" % (what, g.shape, w.shape)
    if not np.array_equal(g, w):
        bad = np.argwhere(g != w)
        i = tuple(bad[0])
        raise AssertionError("%s differs at %d positions, first %s: %s != %s"
                             % (what, len(bad), i, g[i], w[i]))


def tt(a):
    """numpy -> CPU torch tensor (copy)."""
    return torch.from_numpy(np.array(a))
