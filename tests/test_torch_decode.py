"""torch port: the decode path's device modules vs their `dsv2_tpu` twins
on random inputs — dequantization (ops/hzcc.make_dequantize), the inverse
subband transform (ops/sbt.make_inv_sbt, intra and P kinds), motion
compensation (ops/mc), border extension (ops/framedev), the compact scan
upload (codec/devsteps.compact_vs/_expand_vs) — and one P frame decoded
by the port from the JAX decoder's state in mid-stream
(codec/decoder.from_reference). Bit-exact, dtype included."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv2_tpu.codec import decoder as jdec
from dsv2_tpu.codec import devsteps as jdevsteps
from dsv2_tpu.ops import framedev as jframedev
from dsv2_tpu.ops import hzcc as jhzcc
from dsv2_tpu.ops import mc as jmc
from dsv2_tpu.ops import sbt as jsbt
from dsv2_tpu.utils import packet as jpacket
from dsv2_tpu_torch.codec import decoder, devsteps
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.core.frame import coef_dims, plane_dims
from dsv2_tpu_torch.ops import framedev, hzcc, mc, sbt
from dsv2_tpu_torch.utils.packet import VideoMeta
from torch_parity import assert_same, tt
import torch_port_golden as golden  # after torch_parity (sys.path)

NFR = 2   # frames per torch call (the leading frame dimension)
B = K.FRAME_BORDER

# (w, h, subsamp): CIF, the odd-dims fixture, every chroma format at tiny
METAS = [(352, 288, K.SUBSAMP_420), (100, 62, K.SUBSAMP_420),
         (64, 48, K.SUBSAMP_444), (64, 48, K.SUBSAMP_422),
         (64, 48, K.SUBSAMP_411), (64, 48, K.SUBSAMP_410)]
META_IDS = ["%dx%d-%d" % m for m in METAS]
SMALL = METAS[1:]   # the transform and MC cases: JAX compiles each shape
SMALL_IDS = META_IDS[1:]


def _pcfgs(w, h, subsamp, isP, lossless, blk=16):
    args = (VideoMeta(width=w, height=h, subsamp=subsamp), blk, blk, isP,
            lossless)
    return decoder._PCfg(*args), jdec._PCfg(*args)


def _bd(rng, pc):
    flags = np.array([K.IS_RINGING, K.IS_STABLE, K.IS_MAINTAIN, K.IS_INTRA,
                      K.IS_EPRM, K.IS_STABLE | K.IS_RINGING, 0], np.uint8)
    return rng.choice(flags, (NFR, pc.nbv, pc.nbh))


@pytest.mark.parametrize("isP,lossless", [(False, False), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("w,h,subsamp", METAS, ids=META_IDS)
def test_dequantize(w, h, subsamp, isP, lossless):
    pc, jpc = _pcfgs(w, h, subsamp, isP, lossless)
    rng = np.random.default_rng(w + h + subsamp + 7 * isP)
    bd = _bd(rng, pc)
    q = rng.integers(200, 3000, NFR).astype(np.int32)
    ll = rng.integers(-3000, 3000, NFR).astype(np.int32)
    for c in range(3):
        cfg, jcfg = pc.hzcc_cfg(c), jpc.hzcc_cfg(c)
        total = hzcc.total_scan_coefs(cfg.w, cfg.h)
        v = (rng.integers(-40, 41, (NFR, total))
             * (rng.random((NFR, total)) < 0.3)).astype(np.int32)
        got = hzcc.make_dequantize(cfg)(tt(v), tt(bd), tt(q), tt(ll))
        jf = jhzcc.make_dequantize(jcfg)
        for i in range(NFR):
            assert_same(got[i], jf(jnp.asarray(v[i]), jnp.asarray(bd[i]),
                                   jnp.int32(q[i]), jnp.int32(ll[i])),
                        "plane %d frame %d" % (c, i))


@pytest.mark.parametrize("isP,lossless", [(False, False), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("w,h,subsamp", SMALL, ids=SMALL_IDS)
def test_inv_sbt(w, h, subsamp, isP, lossless):
    pc, jpc = _pcfgs(w, h, subsamp, isP, lossless)
    rng = np.random.default_rng(3 * w + h + subsamp + 11 * isP)
    bd = _bd(rng, pc)
    q = rng.integers(200, 3000, NFR).astype(np.int32)
    for c in range(3):
        cfg, jcfg = pc.sbt_cfg(c), jpc.sbt_cfg(c)
        x = rng.integers(-600, 600, (NFR, cfg.ch, cfg.cw)).astype(np.int32)
        x[:, 0, 0] = rng.integers(-30000, 30000, NFR)
        got = sbt.make_inv_sbt(cfg)(tt(x), tt(bd), tt(q))
        jf = jsbt.make_inv_sbt(jcfg)
        for i in range(NFR):
            assert_same(got[i], jf(jnp.asarray(x[i]), jnp.asarray(bd[i]),
                                   jnp.int32(q[i])),
                        "plane %d frame %d" % (c, i))


def test_inv_sbt_stale():
    """The stale-row variant on a degenerate (extreme-aspect) plane."""
    args = (176, 8, False, False, True, 11, 1)
    rng = np.random.default_rng(8)
    x = rng.integers(-300, 300, (8, 176)).astype(np.int32)
    bd = np.zeros((1, 11), np.uint8)
    st = rng.integers(-200, 200, 176).astype(np.int32)
    q = torch.tensor(900, dtype=torch.int32)
    got = sbt.make_inv_sbt_stale(sbt.SbtCfg(*args))(tt(x), tt(bd), q, tt(st))
    want = jsbt.make_inv_sbt_stale(jsbt.SbtCfg(*args))(
        jnp.asarray(x), jnp.asarray(bd), jnp.int32(900), jnp.asarray(st))
    assert_same(got, want)


def _mv_field(rng, pc, intra_pct):
    n = (pc.nbv, pc.nbh)
    mvx = rng.integers(-200, 201, n)
    mvy = rng.integers(-200, 201, n)
    small = rng.random(n) < 0.4
    mvx[small] = rng.integers(-9, 10, small.sum())
    mvy[small] = rng.integers(-9, 10, small.sum())
    r = rng.integers(0, 100, n)
    flags = ((r < intra_pct).astype(np.int64) << K.MV_BIT_INTRA
             | (rng.random(n) < 0.2).astype(np.int64) << K.MV_BIT_SKIP
             | (rng.random(n) < 0.3).astype(np.int64) << K.MV_BIT_EPRM)
    sub = rng.choice(np.array([0, 1, 6, 9, 15]), n)
    dc = rng.integers(0, 512, n) * (rng.random(n) < 0.5)
    return [a.astype(np.int32) for a in (mvx, mvy, flags, sub, dc)]


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("w,h,subsamp", SMALL, ids=SMALL_IDS)
def test_predict_reconstruct(w, h, subsamp, lossless):
    pc, jpc = _pcfgs(w, h, subsamp, True, lossless)
    rng = np.random.default_rng(w * 5 + h + subsamp)
    for c in range(3):
        cfg, jcfg = pc.mc_cfg(c), jpc.mc_cfg(c)
        assert tuple(cfg) == tuple(jcfg)
        ref = rng.integers(0, 256, (cfg.h + 2 * B, cfg.w + 2 * B),
                           dtype=np.uint8)
        mv = _mv_field(rng, pc, 30)
        for tmc in (0, 1):
            got = mc.make_predict(cfg)(tt(ref), *(tt(a) for a in mv),
                                       torch.tensor(tmc, dtype=torch.int32))
            want = jmc.make_predict(jcfg)(jnp.asarray(ref),
                                          *(jnp.asarray(a) for a in mv),
                                          jnp.int32(tmc))
            assert_same(got, want, "predict plane %d tmc %d" % (c, tmc))
        res = rng.integers(0, 256, (cfg.gh, cfg.gw), dtype=np.uint8)
        got = mc.make_reconstruct(cfg)(tt(res), got, tt(mv[2]))
        want = jmc.make_reconstruct(jcfg)(jnp.asarray(res), want,
                                          jnp.asarray(mv[2]))
        assert_same(got, want, "reconstruct plane %d" % c)


@pytest.mark.parametrize("w,h", [(352, 288), (50, 31), (3, 2), (6, 5),
                                 (16, 8)])
def test_extend_plane(w, h):
    rng = np.random.default_rng(w * h)
    vis = rng.integers(0, 256, (NFR, h, w), dtype=np.uint8)
    got = framedev.extend_plane_graph(tt(vis), w, h)
    for i in range(NFR):
        assert_same(got[i], jframedev.extend_plane_graph(
            jnp.asarray(vis[i]), w, h), "frame %d" % i)


@pytest.mark.parametrize("nover", [0, 5, 64, 65])
def test_compact_expand(nover):
    pc, jpc = _pcfgs(100, 62, K.SUBSAMP_420, True, False)
    rng = np.random.default_rng(nover)
    vs = []
    for c in range(3):
        total = hzcc.total_scan_coefs(*pc.cdims[c])
        v = rng.integers(-127, 128, total).astype(np.int32)
        n = devsteps._ll_ns(pc)[c]
        v[:n] = rng.integers(-5000, 5000, n)
        pos = rng.choice(np.arange(n, total), nover, replace=False)
        v[pos] = rng.choice([-1, 1], nover) * rng.integers(128, 900, nover)
        vs.append(v)
    got = devsteps.compact_vs(pc, vs, False)
    want = jdevsteps.compact_vs(jpc, vs, False)
    if nover > devsteps._NFIX:
        assert got is None and want is None
        return
    assert_same(got, want, "compact")
    dev = devsteps._expand_vs(tuple(tuple(tt(a) for a in p) for p in got),
                              False)
    jx = jdevsteps._expand_vs(tuple(tuple(jnp.asarray(a) for a in p)
                                    for p in want), False)
    assert_same(dev, jx, "expand")
    assert_same(dev, vs, "round trip")
    # a leading frame dimension (the K-frame steps)
    st = tuple(tuple(torch.stack([tt(a), tt(a)]) for a in p) for p in got)
    for c, e in enumerate(devsteps._expand_vs(st, False)):
        assert_same(e, np.stack([vs[c], vs[c]]), "batched plane %d" % c)
    assert devsteps.compact_vs(pc, vs, True) == tuple(vs)   # lossless


def test_from_reference():
    """One P frame: the JAX decoder's state after two frames of the tiny
    4:2:2 P stream, carried into the port, decodes the third packet to
    the JAX decoder's frame and reference chain."""
    key = golden.p_key(golden.P_CASES[0])
    data = golden.read_stream(key)
    bufs = [b for _, b in jpacket.iter_packets(io.BytesIO(data))]
    jd = jdec.Decoder()
    npic = 0
    k = 0
    while npic < 2:
        code, _, _ = jd.decode_packet(bufs[k])
        npic += code == jdec.DEC_OK
        k += 1
    code, job, fno = jd.parse_packet(bufs[k])
    assert code == jdec.DEC_OK and job["has_ref"] and job["is_ref"]
    ref = [np.asarray(p) for p in jd.ref_dev["recon"]]
    pjob, chain = decoder.from_reference(job, ref, device="cpu")
    _, realize, _ = jd._execute_job(job)
    want = realize()
    td = decoder.Decoder(device="cpu")
    td.meta, td.ref_dev = pjob["meta"], chain
    code, prealize, pfno = td._execute_job(pjob)
    assert code == decoder.DEC_OK and pfno == fno
    got = prealize()
    for c in range(3):
        assert_same(got.planes[c], want.planes[c], "plane %d" % c)
    assert_same(td.ref_dev["recon"], [np.asarray(p)
                                      for p in jd.ref_dev["recon"]],
                "reference chain")


def test_unported_paths_raise():
    """A corrupt plane, a scan past the compact-upload contract and an
    arena geometry raise; they never fall back quietly."""
    key = golden.p_key(golden.P_CASES[0])
    bufs = [b for _, b in jpacket.iter_packets(
        io.BytesIO(golden.read_stream(key)))]
    td = decoder.Decoder(device="cpu")
    td.parse_packet(bufs[0])
    code, job, _ = td.parse_packet(bufs[1])
    assert code == decoder.DEC_OK
    for change in (dict(bad_planes=[1]), dict(cvs=None)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 18"):
            td._execute_job(dict(job, **change))
    td._use_arena = True
    with pytest.raises(NotImplementedError, match="ROADMAP item 18"):
        td._execute_job(job)
    assert decoder._needs_arena(VideoMeta(width=352, height=16))
    assert not decoder._needs_arena(VideoMeta(width=1920, height=1080))


def test_dims_agree():
    """coef/plane dims and the filter scalars match the twin's."""
    from dsv2_tpu.core import frame as jframe
    for w, h, s in METAS:
        assert coef_dims(s, w, h) == jframe.coef_dims(s, w, h)
        assert plane_dims(s, w, h) == jframe.plane_dims(s, w, h)
        pc, jpc = _pcfgs(w, h, s, True, False)
        for q in (64, 900, 2000):
            assert decoder.compute_filter_q(pc.hzcc_cfg(0), q) == \
                jdec.compute_filter_q(jpc.hzcc_cfg(0), q)


def test_resident_sum():
    """The device-resident digest of a chunked decode equals the pixel sum
    of the frames it would have fetched (mod 2^32)."""
    data = golden.read_stream(golden.p_key(golden.P_CASES[0]))
    frames = [f for _, _, f in decoder.decode_stream_chunked(
        io.BytesIO(data), decoder=decoder.Decoder(device="cpu"))]
    want = sum(int(f.view(c).astype(np.int64).sum())
               for f in frames for c in range(3)) & 0xFFFFFFFF
    rs = decoder.ResidentSum()
    out = list(decoder.decode_stream_chunked(
        io.BytesIO(data), decoder=decoder.Decoder(device="cpu"),
        resident=rs))
    assert len(out) == len(frames) and all(f is None for _, _, f in out)
    assert rs.total() == want
