"""torch port: the decoder arena of the degenerate geometries (352x16
4:2:0, 16x240 4:2:0, 64x500 4:1:1; tests/test_edge_dims.py), whose
subband levels shrink to 1-px sub-dimensions so the reference's shared
transform scratch shows in the decoded pixels.

- ops/sbt.make_inv_sbt_arena vs dsv2_tpu's on random coefficients and a
  random stale scratch row, for every plane of the three geometries
  (intra and P kinds, lossless): pixels and level-1 scratch, bit-exact,
  dtype included;
- each geometry encoded by the port (4 seeded frames, -qp=60 -gop=2)
  to `dsv2_tpu`'s stream, decoded by the port on the device chain with
  the arena to `dsv2_tpu`'s y4m (tools/torch_port_golden.py ARENA_CASES),
  and by the jax-free conformance decoder to the same bytes."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv2_tpu.conformance import d28dec
from dsv2_tpu.ops import sbt as jsbt
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.core import intmath as im
from dsv2_tpu_torch.core.frame import coef_dims
from dsv2_tpu_torch.ops import sbt
from torch_parity import assert_same, tt
import torch_port_golden as golden  # after torch_parity (sys.path)

GOLD = golden.load()
SUBS = {"420": K.SUBSAMP_420, "411": K.SUBSAMP_411}
GEOMS = [(352, 16, "420"), (16, 240, "420"), (64, 500, "411")]
# (w, h, subs, plane, isP, lossless)
PLANES = [(w, h, s, c, isP, False) for w, h, s in GEOMS for c in (0, 1)
          for isP in (False, True)] + [(w, h, s, 1, False, True)
                                       for w, h, s in GEOMS]


@pytest.mark.parametrize("w,h,subs,c,isP,lossless", PLANES,
                         ids=["%dx%d_%s-c%d-%s%s" % (w, h, s, c, "PI"[not p],
                                                     "-ll" * ll)
                              for w, h, s, c, p, ll in PLANES])
def test_inv_sbt_arena(w, h, subs, c, isP, lossless):
    cw, ch = coef_dims(SUBS[subs], w, h)[c]
    nbh, nbv = im.udiv_round_up(w, 16), im.udiv_round_up(h, 16)
    args = (cw, ch, c == 0, isP, lossless, nbh, nbv)
    assert sbt.degenerate(sbt.SbtCfg(*args)) or not lossless
    rng = np.random.default_rng(w * 7 + h + c + 3 * isP + 5 * lossless)
    x = rng.integers(-300, 300, (ch, cw)).astype(np.int32)
    x[::3, ::2] = rng.integers(-4000, 4000, x[::3, ::2].shape)
    flags = np.array([K.IS_RINGING, K.IS_STABLE, K.IS_INTRA, 0], np.uint8)
    bd = rng.choice(flags, (nbv, nbh))
    q = np.int32(rng.integers(200, 2000))
    stale = rng.integers(-5000, 5000, cw).astype(np.int32)
    got = sbt.make_inv_sbt_arena(sbt.SbtCfg(*args))(tt(x), tt(bd), tt(q),
                                                    tt(stale))
    want = jsbt.make_inv_sbt_arena(jsbt.SbtCfg(*args))(
        jnp.asarray(x), jnp.asarray(bd), jnp.asarray(q), jnp.asarray(stale))
    assert_same(got, want, "inverse, scratch")
    assert got[1].shape == (ch, cw)


def _port_stream(name, qp, gop):
    from dsv2_tpu_torch import cli
    frames, meta = cli.read_y4m(golden.input_path(name))
    return golden.encode(cli, frames, meta, qp, gop=gop, device="cpu")


@pytest.mark.parametrize("name,qp,gop", golden.ARENA_CASES,
                         ids=[c[0] for c in golden.ARENA_CASES])
def test_arena_encode_decode(name, qp, gop, tmp_path):
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    want = GOLD[golden.key(name, qp, gop)]
    data = _port_stream(name, qp, gop)
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    dec = decoder.Decoder(device="cpu")
    got = golden.decoded_y4m(decoder, y4m, data, decoder=dec)
    assert golden.digest(got) == want["decode"]
    assert dec._arena is not None and dec._arena.dtype == torch.int32
    assert dec._arena.any()   # the decode threaded the scratch
    path = os.path.join(tmp_path, "s.dsv")
    with open(path, "wb") as f:
        f.write(data)
    d28dec.decode_file(path, path + ".y4m")
    with open(path + ".y4m", "rb") as f:
        assert f.read() == got
