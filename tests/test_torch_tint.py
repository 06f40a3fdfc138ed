"""torch port: C-exact int32 helpers (ops/tint) vs ops/jint, isqrt_u32
and scan_pl._ilog2 of dsv2_tpu."""
import jax.numpy as jnp
import numpy as np
import pytest

from dsv2_tpu.ops import jint, scan_pl
from dsv2_tpu.ops.hme_wave import isqrt_u32
from dsv2_tpu_torch.ops import tint
from torch_parity import assert_same, tt

I32 = np.iinfo(np.int32)
EDGES = np.array([0, 1, -1, 2, -2, 3, -3, 5, -5, 7, -7, 127, -128, 255,
                  256, -256, 65535, -65536, 2 ** 30, -(2 ** 30),
                  I32.max, I32.min, I32.max - 1, I32.min + 1], np.int32)


def _vals(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    r = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
    small = rng.integers(-300, 300, n).astype(np.int32)
    return np.concatenate([EDGES, r, small])


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, 8, 16, 1000])
def test_divt_int(b):
    a = _vals()
    assert_same(tint.divt(tt(a), b), jint.divt(jnp.asarray(a), b))


def test_divt_tensor():
    a = _vals(1)
    rng = np.random.default_rng(2)
    b = rng.integers(-50, 50, a.size).astype(np.int32)
    b[b == 0] = 7
    b[:EDGES.size] = np.resize(np.array([1, -1, 3, -3, I32.max, I32.min],
                                        np.int32), EDGES.size)
    assert_same(tint.divt(tt(a), tt(b)),
                jint.divt(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["round2", "round4", "clamp_u8"])
def test_unary(name):
    a = _vals(3)
    assert_same(getattr(tint, name)(tt(a)),
                getattr(jint, name)(jnp.asarray(a)))


@pytest.mark.parametrize("s", [1, 2, 5, 8, 16, 30])
def test_shifts(s):
    a = _vals(4)
    assert_same(tint.sar(tt(a), s), jint.sar(jnp.asarray(a), s))
    assert_same(tint.sar_r(tt(a), s), jint.sar_r(jnp.asarray(a), s))


def test_clamp():
    a = _vals(5)
    assert_same(tint.clamp(tt(a), -1000, 77),
                jint.clamp(jnp.asarray(a), -1000, 77))


def test_isqrt_u32():
    a = np.concatenate([_vals(6), np.arange(0, 70000, dtype=np.int32),
                        np.array([(k * k) - d for k in (46340, 65535)
                                  for d in (1, 0)], np.int64)
                        .astype(np.uint32).view(np.int32)])
    assert_same(tint.isqrt_u32(tt(a)), isqrt_u32(jnp.asarray(a)))


def test_ilog2():
    a = np.concatenate([_vals(7), (1 << np.arange(31)).astype(np.int32),
                        ((1 << np.arange(1, 31)) - 1).astype(np.int32)])
    assert_same(tint.ilog2(tt(a)), scan_pl._ilog2(jnp.asarray(a)))


def test_dtype_checked():
    with pytest.raises(TypeError):
        tint.divt(tt(np.zeros(3, np.int64)), 2)
