"""torch port: the P-frame encode path on the CPU. Module parity first —
the motion search pyramid (ops/framedev.pyramid_graph) vs the host
pyramid of core/frame, the residual (ops/mc.make_subtract), P
quantization with the psy masks (ops/hzcc.make_quantize) and the P
forward transform (ops/sbt, kind "llp") vs their dsv2_tpu twins on
seeded inputs, bit-exact, dtype included — then the whole path through
the port's CLI factory: every P golden case's stream equals dsv2_tpu's
digest (tests/golden/torch_port_streams.json), and the port's decoder
turns the port's own stream into dsv2_tpu's decoded y4m."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

from dsv2_tpu.codec import decoder as jdec
from dsv2_tpu.ops import hzcc as jhzcc
from dsv2_tpu.ops import mc as jmc
from dsv2_tpu.ops import sbt as jsbt
from dsv2_tpu_torch.codec import decoder
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.core import intmath as im
from dsv2_tpu_torch.core.frame import Frame, ds2x_luma
from dsv2_tpu_torch.ops import framedev, hzcc, mc, sbt
from dsv2_tpu_torch.utils.packet import VideoMeta
from torch_parity import assert_same, tt
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m

GOLD = golden.load()
METAS = [(64, 48, K.SUBSAMP_422), (100, 62, K.SUBSAMP_420)]
META_IDS = ["%dx%d-%d" % m for m in METAS]


def _pcfgs(w, h, subsamp, lossless, do_psy=K.PSY_ALL):
    args = (VideoMeta(width=w, height=h, subsamp=subsamp), 16, 16, True,
            lossless, do_psy)
    return decoder._PCfg(*args), jdec._PCfg(*args)


@pytest.mark.parametrize("name", ["odd100x62_420_4f", "tiny64x48_422_4f"])
def test_pyramid_vs_host(name):
    frames, meta = read_y4m(golden.input_path(name))
    f = Frame(meta.subsamp, meta.width, meta.height, border=True)
    f.load(frames[1])
    f.extend()
    got = framedev.pyramid_graph(tt(f.planes[0]), meta.width, meta.height, 4)
    prev = f
    for lv in range(4):
        d = Frame(meta.subsamp, im.round_shift(meta.width, lv + 1),
                  im.round_shift(meta.height, lv + 1), border=True)
        ds2x_luma(d, prev)
        d.extend(luma_only=True)
        assert_same(got[lv], d.planes[0], "level %d" % (lv + 1))
        prev = d


def _mv_flags(rng, n):
    bits = (K.MV_BIT_INTRA, K.MV_BIT_SKIP, K.MV_BIT_EPRM, K.MV_BIT_NOXMITY,
            K.MV_BIT_NOXMITC)
    return sum((rng.random(n) < 0.25).astype(np.int32) << b for b in bits)


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("w,h,subsamp", METAS, ids=META_IDS)
def test_subtract(w, h, subsamp, lossless):
    pc, jpc = _pcfgs(w, h, subsamp, lossless)
    rng = np.random.default_rng(w + h + lossless)
    for c in range(3):
        cfg, jcfg = pc.mc_cfg(c), jpc.mc_cfg(c)
        res = rng.integers(0, 256, (cfg.gh, cfg.gw), dtype=np.uint8)
        pred = rng.integers(0, 256, (cfg.gh, cfg.gw), dtype=np.uint8)
        fl = _mv_flags(rng, (cfg.nbv, cfg.nbh)).astype(np.int32)
        got = mc.make_subtract(cfg)(tt(res), tt(pred), tt(fl))
        want = jmc.make_subtract(jcfg)(jnp.asarray(res), jnp.asarray(pred),
                                       jnp.asarray(fl))
        assert_same(got, want, "plane %d" % c)


@pytest.mark.parametrize("do_psy", [K.PSY_ALL, 0])
@pytest.mark.parametrize("w,h,subsamp", METAS, ids=META_IDS)
def test_quantize_p(w, h, subsamp, do_psy):
    pc, jpc = _pcfgs(w, h, subsamp, False, do_psy)
    rng = np.random.default_rng(3 * w + h + do_psy)
    flags = np.array([K.IS_INTRA, K.IS_STABLE, K.IS_EPRM, K.IS_SIMCMPLX, 0,
                      K.IS_SIMCMPLX | K.IS_STABLE], np.uint8)
    bd = rng.choice(flags, (pc.nbv, pc.nbh))
    em = rng.random((pc.nbv, pc.nbh)) < 0.3
    mm = rng.random((pc.nbv, pc.nbh)) < 0.3
    for c in range(3):
        cfg, jcfg = pc.hzcc_cfg(c), jpc.hzcc_cfg(c)
        yy, xx = np.mgrid[0:cfg.h, 0:cfg.w]
        x = np.round(rng.laplace(0, 1, (cfg.h, cfg.w))
                     * 3000.0 / (1 + (xx + yy) / 4)).astype(np.int32)
        q = np.int32(rng.integers(200, 3000))
        got = hzcc.make_quantize(cfg)(tt(x), tt(bd), tt(q), tt(em), tt(mm))
        want = jhzcc.make_quantize(jcfg)(jnp.asarray(x), jnp.asarray(bd),
                                         jnp.asarray(em), jnp.asarray(mm),
                                         jnp.int32(q))
        assert_same(got, want, "plane %d" % c)
    with pytest.raises(ValueError):
        hzcc.make_quantize(pc.hzcc_cfg(0))(tt(x), tt(bd), tt(q))


@pytest.mark.parametrize("w,h,subsamp", METAS, ids=META_IDS)
def test_fwd_sbt_p(w, h, subsamp):
    pc, jpc = _pcfgs(w, h, subsamp, False)
    rng = np.random.default_rng(7 * w + h)
    bd = rng.integers(0, 64, (pc.nbv, pc.nbh)).astype(np.uint8)
    for c in range(3):
        cfg, jcfg = pc.sbt_cfg(c), jpc.sbt_cfg(c)
        assert (c == 0) == any(sbt._kind(cfg, l) == "llp"
                               for l in range(1, cfg.lvls + 1))
        x = rng.integers(-128, 128, (cfg.ch, cfg.cw)).astype(np.int32)
        got = sbt.make_fwd_sbt_carry(cfg)(tt(x), tt(bd))
        want = jsbt.make_fwd_sbt_carry(jcfg)(jnp.asarray(x), jnp.asarray(bd))
        assert_same(got, want, "plane %d" % c)


# the small cases (CIF and FHD P encode run on the card:
# tests/test_torch_cuda.py, chip_smoke.py)
P_ALL = [golden.P_CASES[0] + (None,)] + golden.P_DIGESTS


@pytest.mark.parametrize("case", P_ALL, ids=[golden.p_key(c) for c in P_ALL])
def test_p_encode_golden(case):
    """The port's sequential encode (on the CPU: the plain motion search)
    of every P golden case is dsv2_tpu's stream; the port decodes it to
    dsv2_tpu's decoded y4m."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.utils import y4m
    name, qp, gop, nfr, effort = case
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames[:nfr], meta, qp, gop=gop, effort=effort,
                         device="cpu")
    want = GOLD[golden.p_key(case)]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    y = golden.decoded_y4m(decoder, y4m, data,
                           decoder=decoder.Decoder(device="cpu"))
    assert golden.digest(y) == want["decode"]


def test_cli_p_encode(tmp_path):
    """`e -gop=4` through the CLI entry point writes the golden stream."""
    from dsv2_tpu_torch import cli
    key = golden.p_key(golden.P_CASES[0])
    out = str(tmp_path / "t.dsv")
    assert cli.main(["e", "-y", "-y4m=1", "-qp=60", "-gop=4",
                     "-inp=" + golden.input_path(golden.P_CASES[0][0]),
                     "-out=" + out]) == 0
    with open(out, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == GOLD[key]["sha256"]
