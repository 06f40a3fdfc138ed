"""torch port: the chain steps of a lockstep flush
(dsv2_tpu_torch/codec/devsteps.make_*_lanes) against the same builders
run as a flush of one lane per lane (devsteps.run_one, the path of a
step outside lockstep).

Three lanes of seeded inputs at the tiny (64x48) and nano (48x32) 4:2:0
geometries, each lane with its own q, filter q and threshold, filter
flag, temporal MC parity, motion field and reference, go through each
builder (input prep, intra and P encode chain steps, intra and P decode
chain steps) once for all lanes and once per lane; every output must
agree bit for bit, dtype included, and each lane's host fetch of the
merged blob must equal the one-lane flush's. The decode lanes are also
held against the decoder's one-frame steps. MC with a lane axis is held
against one-plane calls. Counting wrappers show one filter wavefront
call per filter kind and one vk chain call per plane for the whole
flush. Everything runs the plain versions on the CPU.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_same, tt
from dsv2_tpu_torch.codec import devsteps
from dsv2_tpu_torch.codec.decoder import _PCfg
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.core.frame import plane_dims
from dsv2_tpu_torch.ops import filters, hzcc, mc, scan_pl
from dsv2_tpu_torch.utils.packet import VideoMeta

B = K.FRAME_BORDER
L = 3
LEVELS = 2
BLK = 16
GEOMS = {"tiny": (64, 48, K.SUBSAMP_420), "nano": (48, 32, K.SUBSAMP_420)}
# the lockstep cell's geometry, for the card's cases (test_torch_cuda.py)
CIF = (352, 288, K.SUBSAMP_420)


def _geom(geom):
    return CIF if geom == "cif" else GEOMS[geom]


def _pcfg(geom, isP, lossless=False, do_psy=K.PSY_ALL):
    w, h, subsamp = _geom(geom)
    return _PCfg(VideoMeta(width=w, height=h, subsamp=subsamp), BLK, BLK,
                 isP, lossless, do_psy)


def _rng(geom, salt):
    return np.random.default_rng(sum(_geom(geom)[:2]) * 31 + salt)


def _bordered(rng, pcfg):
    return [tt(rng.integers(0, 256, (ph + 2 * B, pw + 2 * B),
                            dtype=np.uint8)) for pw, ph in pcfg.pdims]


def _mv_grids(rng, pcfg, lane):
    """mvx, mvy, flags, submask, dc (nbv, nbh) int32 of one lane."""
    shape = (pcfg.nbv, pcfg.nbh)
    span = 8 + 24 * lane
    flags = sum((rng.random(shape) < 0.25).astype(np.int32) << b
                for b in (K.MV_BIT_INTRA, K.MV_BIT_EPRM, K.MV_BIT_MAINTAIN,
                          K.MV_BIT_SKIP, K.MV_BIT_NOXMITY, K.MV_BIT_NOXMITC))
    dc = np.where(rng.random(shape) < 0.5, 0,
                  rng.integers(0, 512, shape)).astype(np.int32)
    return [rng.integers(-span, span + 1, shape).astype(np.int32),
            rng.integers(-span, span + 1, shape).astype(np.int32),
            flags.astype(np.int32),
            rng.integers(0, 16, shape).astype(np.int32), dc]


# per-lane scalars: q, fq, fthresh, do_filter, frame number (tmc parity);
# the CPU tests take the first L lanes
SCALARS = [(700, 900, 160, 1, 1), (1500, 1100, 128, 0, 2),
           (2400, 1536, 96, 1, 7), (300, 662, 192, 1, 4),
           (1024, 1024, 128, 1, 9), (3000, 1536, 96, 0, 10),
           (60, 542, 192, 1, 13), (1800, 1412, 128, 1, 16)]


class Counts:
    """Counting wrappers of filters.wavefront_filter (by kind) and
    scan_pl.vk_chain (calls) over a block."""

    def __init__(self, monkeypatch):
        self.filters, self.vk = {}, 0
        wf, vk = filters.wavefront_filter, scan_pl.vk_chain

        def wf_counted(kind, *a):
            self.filters[kind] = self.filters.get(kind, 0) + 1
            return wf(kind, *a)

        def vk_counted(*a, **kw):
            self.vk += 1
            return vk(*a, **kw)
        monkeypatch.setattr(filters, "wavefront_filter", wf_counted)
        monkeypatch.setattr(scan_pl, "vk_chain", vk_counted)

    def take(self):
        out = (dict(self.filters), self.vk)
        self.filters, self.vk = {}, 0
        return out


def _check_lane_out(got, want, i):
    """A LaneOut against another (a one-lane flush's): equal scans, chain
    and host fetch."""
    assert isinstance(got, devsteps.LaneOut) and got.lane == i
    assert_same(got.vs, want[2], "lane %d vs" % i)
    for k in want[3]:
        assert_same(got.chain[k], want[3][k], "lane %d %s" % (i, k))
    gv, gl = devsteps.fetch_sparse_outs(got)
    wv, wl = devsteps.fetch_sparse_outs(want)
    assert gl == wl, ("lls", i)
    for c, ((gk, gp), (wk, wp)) in enumerate(zip(gv, wv)):
        assert gk == wk, ("fetch kind", i, c)
        assert_same(np.asarray(gp), np.asarray(wp), "lane %d fetch %d"
                    % (i, c))


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_input_prep_lanes(geom):
    w, h, subsamp = GEOMS[geom]
    rng = _rng(geom, 1)
    lanes = [tuple(tt(rng.integers(0, 256, (ph, pw), dtype=np.uint8))
                   for pw, ph in plane_dims(subsamp, w, h))
             for _ in range(L)]
    cfg = (w, h, subsamp, LEVELS)
    got = devsteps.make_input_prep_lanes(cfg)(lanes)
    for i, args in enumerate(lanes):
        want = _one(("input_prep", cfg), devsteps.make_input_prep_lanes,
                    args)
        for k in want:
            assert_same(got[i][k], want[k], "lane %d %s" % (i, k))


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_i_chain_lanes(geom, monkeypatch):
    w, h, subsamp = GEOMS[geom]
    lanes = i_lanes(geom, 2)
    cfg = (w, h, subsamp, BLK, BLK, False, K.PSY_ALL, LEVELS)
    counts = Counts(monkeypatch)
    got = devsteps.make_i_chain_lanes(cfg)(lanes)
    assert counts.take() == ({"intra": 1}, 3)
    for i, args in enumerate(lanes):
        _check_lane_out(got[i], _one(("i_chain", cfg),
                                     devsteps.make_i_chain_lanes, args), i)
    assert counts.take() == ({"intra": L}, 3 * L)


def _one(key, builder, args):
    """One lane's step outside lockstep: a flush of that lane alone."""
    return devsteps.run_one(key, builder, args, "cpu")


def i_lanes(geom, salt, n=L):
    """Lane argument tuples of make_i_chain_lanes for n lanes."""
    pcfg = _pcfg(geom, False)
    rng = _rng(geom, salt)
    lanes = []
    for q, fq, fthresh, do_filter, _ in SCALARS[:n]:
        xs = [tt(rng.integers(0, 256, (1, ch, cw), dtype=np.uint8))
              for cw, ch in pcfg.cdims]
        bd = tt(rng.integers(0, 16, (1, pcfg.nbv, pcfg.nbh), dtype=np.uint8))
        lanes.append((xs, bd, tt(np.array([q], np.int32)), fq, fthresh,
                      do_filter))
    return lanes


def p_grids(rng, pcfg, lane):
    """The (8, nbv, nbh) int32 grids of a P lane as p_chain_ints takes
    them: mvx, mvy, flags, submask, dc, blockdata, eprm, mlt."""
    g = _mv_grids(rng, pcfg, lane)
    bd = rng.integers(0, 16, (pcfg.nbv, pcfg.nbh)).astype(np.uint8)
    eprm = rng.random(bd.shape) < 0.3
    mlt = rng.random(bd.shape) < 0.3
    return np.stack([a.astype(np.int32) for a in g + [bd, eprm, mlt]])


def p_lanes(geom, salt, n=L, scalars=None):
    """Lane argument tuples (srcs_full, refs, ints) of make_p_chain_lanes
    for n lanes; `scalars` (q, tmc, fq, fthresh, do_filter) per lane, by
    default from SCALARS."""
    pcfg = _pcfg(geom, True)
    rng = _rng(geom, salt)
    lanes = []
    for i, (q, fq, fthresh, do_filter, fno) in enumerate(SCALARS[:n]):
        grids = p_grids(rng, pcfg, i)
        sc = (scalars[i] if scalars is not None else
              (q, K.temporal_mc(fno), fq, fthresh, do_filter))
        lanes.append((_bordered(rng, pcfg), _bordered(rng, pcfg),
                      tt(devsteps.p_chain_ints(grids, *sc))))
    return lanes


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_p_chain_lanes(geom, monkeypatch):
    w, h, subsamp = GEOMS[geom]
    lanes = p_lanes(geom, 3)
    cfg = (w, h, subsamp, BLK, BLK, False, K.PSY_ALL, LEVELS, 1)
    counts = Counts(monkeypatch)
    got = devsteps.make_p_chain_lanes(cfg)(lanes)
    assert counts.take() == ({"luma": 1, "chroma": 1}, 3)
    for i, args in enumerate(lanes):
        _check_lane_out(got[i], _one(("p_chain", cfg),
                                     devsteps.make_p_chain_lanes, args), i)
    assert counts.take() == ({"luma": L, "chroma": L}, 3 * L)


def _scans(rng, pcfg, dense):
    """One picture's scans in scan_upload's form: dense int32 vectors, or
    the compact (LL prefix, int8 tail, fixups) with a few fixups used."""
    vs = []
    for c, (cw, ch) in enumerate(pcfg.cdims):
        total = hzcc.total_scan_coefs(cw, ch)
        v = np.where(rng.random(total) < 0.2,
                     rng.integers(-30, 31, total), 0).astype(np.int32)
        v[:devsteps._ll_ns(pcfg)[c]] = rng.integers(-2000, 2000,
                                                    devsteps._ll_ns(pcfg)[c])
        over = rng.choice(np.arange(devsteps._ll_ns(pcfg)[c], total), 3,
                          replace=False)
        v[over] = rng.integers(128, 900, 3) * rng.choice([-1, 1], 3)
        vs.append(v)
    cvs, was_dense = devsteps.scan_upload(pcfg, vs, False)
    if dense:
        return tuple(vs)
    assert not was_dense
    return cvs


def decode_lanes(geom, isP, dense, bad, arena, salt, n=L):
    """Lane argument tuples of make_{id,pd}_chain_lanes for n lanes, host
    arrays and ints standing in for tensors, and the arguments of the
    one-frame steps make_{id,pd}_chain_step, tensors."""
    pcfg = _pcfg(geom, isP, do_psy=0)
    rng = _rng(geom, salt)
    host, dev = [], []
    for i, (q, fq, fthresh, do_filter, fno) in enumerate(SCALARS[:n]):
        vs = _scans(rng, pcfg, dense)
        bd = rng.integers(0, 16, (pcfg.nbv, pcfg.nbh)).astype(np.uint8)
        lls = rng.integers(-500, 500, 3).astype(np.int32)
        ar = (torch.zeros(3 * pcfg.meta.width, dtype=torch.int32)
              if arena else None)
        h = (vs, bd, np.int32(q), lls)
        d = (tuple(tuple(tt(x) for x in p) if isinstance(p, tuple)
                   else tt(p) for p in vs), tt(bd), tt(np.int32(q)), tt(lls))
        if isP:
            refs = tuple(_bordered(rng, pcfg))
            g = _mv_grids(rng, pcfg, i)
            tmc = K.temporal_mc(fno)
            h += (refs,) + tuple(g) + (tmc,)
            d += (refs,) + tuple(tt(a) for a in g) + (tt(np.int32(tmc)),)
        host.append(h + (fq, fthresh, do_filter, bad,
                         None if ar is None else ar.clone()))
        d += tuple(tt(np.int32(x)) for x in (fq, fthresh, do_filter))
        dev.append((d, ar))
    return host, dev


@pytest.mark.parametrize("case", ["compact", "dense", "bad", "arena"])
@pytest.mark.parametrize("kind", ["id", "pd"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_decode_chain_lanes(geom, kind, case, monkeypatch):
    isP = kind == "pd"
    w, h, subsamp = GEOMS[geom]
    dense = case == "dense"
    bad = (1,) if case == "bad" else ()
    arena = case == "arena"
    host, dev = decode_lanes(geom, isP, dense, bad, arena,
                              4 + 2 * isP + dense)
    base = (w, h, subsamp, BLK, BLK, False) + ((1,) if isP else ())
    make = devsteps.make_pd_chain_step if isP else devsteps.make_id_chain_step
    builder = (devsteps.make_pd_chain_lanes if isP
               else devsteps.make_id_chain_lanes)
    key = (kind + "_chain", base + (dense, bad, arena, "cpu"))
    fresh = [a[:-1] + (None if a[-1] is None else a[-1].clone(),)
             for a in host]
    counts = Counts(monkeypatch)
    got = builder(key[1])(host)
    kinds = {"luma": 1, "chroma": 1} if isP else {"intra": 1}
    if arena:
        kinds = {k: L for k in kinds}
    assert counts.take() == (kinds, 0)
    for i, args in enumerate(fresh):
        packed, chain = _one(key, builder, args)
        assert_same(got[i][0], packed, "lane %d one-lane payload" % i)
        assert_same(got[i][1]["recon"], chain["recon"],
                    "lane %d one-lane recon" % i)
        if arena:
            assert_same(host[i][-1], args[-1], "lane %d one-lane arena" % i)
    assert counts.take() == ({k: L for k in kinds}, 0)
    one = make(*base, dense)
    for i, (args, ar) in enumerate(dev):
        packed, chain = one(*args, bad=bad, arena=ar)
        assert_same(got[i][0], packed, "lane %d payload" % i)
        assert_same(got[i][1]["recon"], chain["recon"], "lane %d recon" % i)
        if arena:
            assert_same(host[i][-1], ar, "lane %d arena" % i)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_mc_lane_axis(geom):
    """make_predict / make_subtract / make_reconstruct over (L, ...)
    against one call per plane; with one lane, equal to the one-plane
    call."""
    pcfg = _pcfg(geom, True)
    rng = _rng(geom, 9)
    for c in range(3):
        cfg = pcfg.mc_cfg(c)
        refs = torch.stack([_bordered(rng, pcfg)[c] for _ in range(L)])
        g = [torch.stack([tt(a) for a in gs]) for gs in
             zip(*(_mv_grids(rng, pcfg, i) for i in range(L)))]
        tmc = torch.tensor([K.temporal_mc(s[4]) for s in SCALARS[:L]],
                           dtype=torch.int32)
        src = tt(rng.integers(0, 256, (L, cfg.gh, cfg.gw), dtype=np.uint8))
        pred = mc.make_predict(cfg)(refs, *g, tmc)
        res = mc.make_subtract(cfg)(src, pred, g[2])
        rec = mc.make_reconstruct(cfg)(res, pred, g[2])
        for i in range(L):
            gi = [x[i] for x in g]
            want = mc.make_predict(cfg)(refs[i], *gi, int(tmc[i]))
            assert_same(pred[i], want, "plane %d lane %d pred" % (c, i))
            assert_same(mc.make_predict(cfg)(refs[i:i + 1],
                                             *[x[i:i + 1] for x in g],
                                             tmc[i:i + 1])[0], want)
            assert_same(res[i], mc.make_subtract(cfg)(src[i], want, gi[2]))
            assert_same(rec[i], mc.make_reconstruct(cfg)(res[i], want,
                                                         gi[2]))
