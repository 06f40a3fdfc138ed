"""torch port: forward subband transform (ops/sbt.make_fwd_sbt_carry) vs
dsv2_tpu's JAX transform on random planes — coefficients and the
scratch-row carry, every intra filter kind, ringing blockdata, extreme
aspect ratios (the degenerate-level carry)."""
import jax.numpy as jnp
import numpy as np
import pytest

from dsv2_tpu.core import constants as K
from dsv2_tpu.core import intmath as im
from dsv2_tpu.ops import sbt as jsbt
from dsv2_tpu_torch.ops import sbt
from torch_parity import assert_same, tt

NFR = 2   # frames per torch call (the leading frame dimension)

# (cw, ch, is_luma, lossless): CIF luma/chroma, odd100x62 luma/chroma
# (chroma coef dims rounded to even), and the extreme-aspect geometries
# whose degenerate levels read the stale scratch row
CASES = [
    (352, 288, True, False), (176, 144, False, False),
    (352, 288, True, True), (176, 144, False, True),
    (100, 62, True, False), (50, 32, False, False),
    (352, 16, True, False), (176, 8, False, False), (176, 8, False, True),
    (16, 240, True, False), (8, 120, False, False), (8, 120, False, True),
    (64, 500, True, False), (32, 250, False, False), (32, 250, False, True),
]


def _inputs(cw, ch, nbh, nbv, seed):
    rng = np.random.default_rng(seed)
    # smooth gradients + noise + hard edges, centered like p2sbc
    yy, xx = np.mgrid[0:ch, 0:cw]
    x = ((xx * 3 + yy * 2) % 256 - 128
         + rng.integers(-40, 40, (NFR, ch, cw))).astype(np.int32)
    x[:, :, ::7] = rng.integers(-128, 128, (NFR, ch, (cw + 6) // 7))
    flags = (K.IS_RINGING, K.IS_STABLE, K.IS_MAINTAIN,
             K.IS_RINGING | K.IS_STABLE, 0)
    bd = rng.choice(np.array(flags, np.uint8), (NFR, nbv, nbh))
    return x, bd


@pytest.mark.parametrize("cw,ch,is_luma,lossless", CASES)
def test_fwd_sbt_carry(cw, ch, is_luma, lossless):
    nbh = im.udiv_round_up(max(cw, 16), 16)
    nbv = im.udiv_round_up(max(ch, 16), 16)
    args = (cw, ch, is_luma, False, lossless, nbh, nbv)
    x, bd = _inputs(cw, ch, nbh, nbv, seed=cw * 1000 + ch)
    got = sbt.make_fwd_sbt_carry(sbt.SbtCfg(*args))(tt(x), tt(bd))
    jf = jsbt.make_fwd_sbt_carry(jsbt.SbtCfg(*args))
    for i in range(NFR):
        want = jf(jnp.asarray(x[i]), jnp.asarray(bd[i]))
        assert_same((got[0][i], got[1][i]), want, "frame %d" % i)
    assert sbt.degenerate(sbt.SbtCfg(*args)) == jsbt.degenerate(
        jsbt.SbtCfg(*args))


def test_cfg_fields():
    assert sbt.SbtCfg._fields == jsbt.SbtCfg._fields
    cfg = (352, 288, True, False, False, 22, 18)
    assert sbt.SbtCfg(*cfg).lvls == jsbt.SbtCfg(*cfg).lvls
    for l in range(1, 9):
        for lossless in (False, True):
            for luma in (False, True):
                c = (352, 288, luma, False, lossless, 22, 18)
                assert sbt._kind(sbt.SbtCfg(*c), l) == jsbt._kind(
                    jsbt.SbtCfg(*c), l)
                assert sbt._ovf(sbt.SbtCfg(*c), l) == jsbt._ovf(
                    jsbt.SbtCfg(*c), l)


def test_p_frames_not_ported():
    with pytest.raises(NotImplementedError):
        sbt.make_fwd_sbt_carry(sbt.SbtCfg(64, 48, True, True, False, 4, 3))
