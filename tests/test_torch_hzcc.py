"""torch port: quantization (ops/hzcc.make_quantize, intra) and the scan
geometry vs dsv2_tpu's JAX hzcc, on random coefficient planes."""
import jax.numpy as jnp
import numpy as np
import pytest

from dsv2_tpu.core import constants as K
from dsv2_tpu.core import intmath as im
from dsv2_tpu.ops import hzcc as jhzcc
from dsv2_tpu_torch.ops import hzcc
from torch_parity import assert_same, tt

NFR = 2
DIMS = [(352, 288), (176, 144), (100, 62), (50, 32), (64, 48), (32, 24),
        (352, 16), (16, 240), (32, 250), (1920, 1080), (960, 540)]


@pytest.mark.parametrize("w,h", DIMS)
def test_geometry(w, h):
    assert hzcc.subband_plan(w, h) == jhzcc.subband_plan(w, h)
    assert hzcc.scan_segments(w, h) == jhzcc.scan_segments(w, h)
    assert hzcc.total_scan_coefs(w, h) == jhzcc.total_scan_coefs(w, h)
    nbh, nbv = im.udiv_round_up(w, 16), im.udiv_round_up(h, 16)
    for (l, s, r0, c0, sw, sh) in hzcc.subband_plan(w, h):
        for a, b in zip(hzcc._block_gather(sw, sh, nbh, nbv),
                        jhzcc._block_gather(sw, sh, nbh, nbv)):
            np.testing.assert_array_equal(a, b)
        m, jm = (hzcc._self_parent_mask(w, h, l, s),
                 jhzcc._self_parent_mask(w, h, l, s))
        assert (m is None) == (jm is None)
        if m is not None:
            np.testing.assert_array_equal(m, jm)
    assert hzcc.HzccCfg._fields == jhzcc.HzccCfg._fields


def _inputs(w, h, nbh, nbv, seed, lossless):
    rng = np.random.default_rng(seed)
    # laplacian-ish coefficients, larger toward the LL corner
    yy, xx = np.mgrid[0:h, 0:w]
    scale = 4000.0 / (1 + (xx + yy) / 4)
    x = np.round(rng.laplace(0, 1, (NFR, h, w)) * scale).astype(np.int32)
    if lossless:
        x = np.clip(x, -600, 600)
    flags = (K.IS_RINGING, K.IS_STABLE, K.IS_MAINTAIN, 0,
             K.IS_STABLE | K.IS_MAINTAIN, K.IS_RINGING | K.IS_MAINTAIN)
    bd = rng.choice(np.array(flags, np.uint8), (NFR, nbv, nbh))
    q = rng.integers(40, 3000, NFR).astype(np.int32)
    return x, bd, q


# (w, h, is_luma, lossless, do_psy)
CASES = [
    (352, 288, True, False, K.PSY_ALL), (352, 288, True, False, 0),
    (176, 144, False, False, K.PSY_ALL), (176, 144, False, False, 0),
    (352, 288, True, True, K.PSY_ALL), (176, 144, False, True, K.PSY_ALL),
    (100, 62, True, False, K.PSY_ALL), (50, 32, False, False, K.PSY_ALL),
    (32, 250, False, False, K.PSY_ALL), (352, 16, True, False, K.PSY_ALL),
]


@pytest.mark.parametrize("w,h,is_luma,lossless,do_psy", CASES)
def test_make_quantize(w, h, is_luma, lossless, do_psy):
    nbh = im.udiv_round_up(max(w, 16), 16)
    nbv = im.udiv_round_up(max(h, 16), 16)
    args = (w, h, is_luma, False, lossless, nbh, nbv, 16, 16, 352, 288,
            K.SUBSAMP_420, do_psy)
    x, bd, q = _inputs(w, h, nbh, nbv, seed=w + 7 * h + do_psy, lossless=
                       lossless)
    got = hzcc.make_quantize(hzcc.HzccCfg(*args))(tt(x), tt(bd), tt(q))
    jf = jhzcc.make_quantize(jhzcc.HzccCfg(*args))
    dummy = jnp.zeros((nbv, nbh), bool)
    for i in range(NFR):
        want = jf(jnp.asarray(x[i]), jnp.asarray(bd[i]), dummy, dummy,
                  jnp.int32(q[i]))
        assert_same((got[0][i], got[1][i]), want, "frame %d" % i)


@pytest.mark.parametrize("s", [1, 2, 3, -1])
def test_psy_factor(s):
    cfg = hzcc.HzccCfg(1920, 1080, True, False, False, 120, 68, 16, 16,
                       1920, 1080, K.SUBSAMP_420, K.PSY_ALL)
    assert hzcc.spatial_psy_factor(cfg, s) == jhzcc.spatial_psy_factor(cfg, s)


def test_p_frames_not_ported():
    cfg = hzcc.HzccCfg(64, 48, True, True, False, 4, 3, 16, 16, 64, 48,
                       K.SUBSAMP_420, 0)
    with pytest.raises(NotImplementedError):
        hzcc.make_quantize(cfg)
