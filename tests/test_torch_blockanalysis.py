"""torch port: device HVS intra analysis (ops/blockanalysis.
device_intra_flags) vs dsv2_tpu's JAX twin, on random planes and on the
fixtures."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsv2_tpu.codec.decoder import _PCfg as JPCfg
from dsv2_tpu.core import constants as K
from dsv2_tpu.core.frame import coef_dims, plane_dims
from dsv2_tpu.ops import blockanalysis as jba
from dsv2_tpu.utils.packet import VideoMeta
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.codec.decoder import _PCfg
from dsv2_tpu_torch.ops import blockanalysis as ba
from torch_parity import assert_same, tt
from torch_port_golden import FIXTURES  # after torch_parity


def _planes(meta, frames):
    """Coef-dim interior planes (B, ch, cw) uint8 per component, padded
    with 128 below the visible rows, as the batched step receives them."""
    out = []
    cd = coef_dims(meta.subsamp, meta.width, meta.height)
    pd = plane_dims(meta.subsamp, meta.width, meta.height)
    for c in range(3):
        (cw, ch), (pw, ph) = cd[c], pd[c]
        x = np.full((len(frames), ch, cw), 128, np.uint8)
        for i, fr in enumerate(frames):
            x[i, :ph, :min(pw, cw)] = fr[c][:, :min(pw, cw)]
        out.append(x)
    return out


def _check(meta, planes, blk, do_psy):
    args = (meta, blk, blk, False, False, do_psy)
    jp = JPCfg(*args)
    assert ba.device_analysis_ok(_PCfg(*args)) and jba.device_analysis_ok(jp)
    got = ba.device_intra_flags(_PCfg(*args))(*(tt(p) for p in planes))
    jf = jax.jit(jba.device_intra_flags(jp))
    for i in range(planes[0].shape[0]):
        want = jf(*(jnp.asarray(p[i]) for p in planes))
        assert_same(tuple(g[i] for g in got), want, "frame %d" % i)


@pytest.mark.parametrize("w,h,subsamp,blk,do_psy", [
    (64, 48, K.SUBSAMP_420, 16, K.PSY_ALL),
    (96, 64, K.SUBSAMP_444, 16, K.PSY_ALL),
    (128, 64, K.SUBSAMP_422, 32, K.PSY_ALL),
    (64, 48, K.SUBSAMP_420, 16, K.PSY_ADAPTIVE_RINGING),
    (64, 48, K.SUBSAMP_420, 16, K.PSY_CONTENT_ANALYSIS),
    (64, 48, K.SUBSAMP_420, 16, 0),
])
def test_random_planes(w, h, subsamp, blk, do_psy):
    rng = np.random.default_rng(w * h + do_psy)
    meta = VideoMeta(width=w, height=h, subsamp=subsamp)
    frames = []
    for t in range(3):
        fr = []
        for (pw, ph) in plane_dims(subsamp, w, h):
            yy, xx = np.mgrid[0:ph, 0:pw]
            base = (xx * (t + 1) * 5 + yy * 3) % 256
            noise = rng.integers(0, 256, (ph, pw))
            mix = np.where(rng.random((ph, pw)) < 0.3 * t, noise, base)
            fr.append((mix // (t + 1)).astype(np.uint8))
        frames.append(fr)
    _check(meta, _planes(meta, frames), blk, do_psy)


@pytest.mark.parametrize("name", sorted(
    f[:-4] for f in os.listdir(FIXTURES) if f.endswith(".y4m")))
def test_fixtures(name):
    frames, meta = read_y4m(os.path.join(FIXTURES, name + ".y4m"))
    blk = 16
    _check(meta, _planes(meta, frames[:3]), blk, K.PSY_ALL)
