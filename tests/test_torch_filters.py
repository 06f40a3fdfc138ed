"""torch port: the in-loop filter wavefront (ops/filters.py), plain
version, bit-exact against `dsv2_tpu`'s XLA filters, its Pallas kernels in
interpret mode (VMEM and HBM variants) and the port's native C filters,
on adversarial random planes and motion fields."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv2_tpu.ops import filters as jfilters
from dsv2_tpu.ops import filters_pl
from dsv2_tpu_torch import native
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.ops import filters
from torch_parity import REPO, assert_same, tt


def _rand_plane(rng, w, h):
    """Half smooth / half noisy, with flat patches and a gradient, so the
    flat6 tests and the de-gradient sharpener fire both ways."""
    noise = rng.integers(0, 256, (h, w), dtype=np.uint8)
    base = rng.integers(0, 256, (-(-h // 8), -(-w // 8)))
    smooth = np.kron(base, np.ones((8, 8), dtype=np.int64))[:h, :w]
    sel = np.kron(rng.integers(0, 2, (h // 16 + 1, w // 16 + 1)),
                  np.ones((16, 16), dtype=np.int64))[:h, :w]
    out = np.where(sel, smooth, noise >> 2 << 2)
    out[: h // 4, : w // 4] = 128
    out[-(h // 4):, :] = np.arange(w, dtype=np.int64) % 256
    return out.astype(np.uint8)


def _rand_field(rng, nbh, nbv):
    """(mvx, mvy, flags, submask) int32 (nbv, nbh) grids: intra, skip,
    EPRM and small-vector blocks all present."""
    n = nbh * nbv
    mvx = rng.integers(-40, 41, n)
    mvy = rng.integers(-40, 41, n)
    r = rng.integers(0, 100, n)
    flags = ((r < 20).astype(np.int64) << K.MV_BIT_INTRA
             | ((r >= 20) & (r < 40)).astype(np.int64) << K.MV_BIT_SKIP
             | (rng.integers(0, 4, n) == 0).astype(np.int64)
             << K.MV_BIT_EPRM)
    tiny = rng.integers(0, 3, n) == 0
    mvx[tiny] = rng.integers(-2, 3, tiny.sum())
    mvy[tiny] = rng.integers(-2, 3, tiny.sum())
    sub = rng.integers(0, 16, n)
    return [a.astype(np.int32).reshape(nbv, nbh)
            for a in (mvx, mvy, flags, sub)]


def _fthresh(fq):
    return 32 * (14 - max(fq.bit_length() - 1, 1))


def _case(kind, w, h, nbh, nbv, seed):
    """Inputs of one filter call: (plane, args) with args as numpy."""
    rng = np.random.default_rng(seed)
    vis = _rand_plane(rng, w, h)
    fq = int(rng.integers(512, 1700))
    if kind == "intra":
        bd = rng.integers(0, 256, (nbv, nbh)).astype(np.uint8)
        return vis, dict(bd=bd, fq=fq, fth=_fthresh(fq))
    mvx, mvy, flags, sub = _rand_field(rng, nbh, nbv)
    return vis, dict(mvx=mvx, mvy=mvy, flags=flags, sub=sub, fq=fq,
                     fth=_fthresh(fq), q=int(rng.integers(100, 3000)))


def _port(kind, geo, vis, a, df=1, tmc=1, sharpen=1):
    w, h, nbh, nbv, bw, bh = geo
    t = {k: tt(v) for k, v in a.items() if isinstance(v, np.ndarray)}
    if kind == "intra":
        return filters.intra_filter_graph(w, h, nbh, nbv, tt(vis), t["bd"],
                                          a["fq"], a["fth"] * df)
    if kind == "luma":
        return filters.luma_filter_graph(
            w, h, nbh, nbv, bw, bh, sharpen, tt(vis), t["mvx"], t["mvy"],
            t["flags"], t["sub"], a["fq"], a["fth"], df, tmc)
    return filters.chroma_filter_graph(w, h, nbh, nbv, bw, bh, tt(vis),
                                       t["mvx"], t["mvy"], t["flags"],
                                       a["q"])


def _jax(mod, kind, geo, vis, a, df=1, tmc=1, sharpen=1):
    w, h, nbh, nbv, bw, bh = geo
    j = {k: jnp.asarray(v) for k, v in a.items() if isinstance(v, np.ndarray)}
    i32 = jnp.int32
    if kind == "intra":
        return mod.intra_filter_graph(w, h, nbh, nbv, jnp.asarray(vis),
                                      j["bd"], i32(a["fq"]),
                                      i32(a["fth"] * df))
    if kind == "luma":
        return mod.luma_filter_graph(
            w, h, nbh, nbv, bw, bh, sharpen, jnp.asarray(vis), j["mvx"],
            j["mvy"], j["flags"], j["sub"], i32(a["fq"]), i32(a["fth"]),
            i32(df), i32(tmc))
    return mod.chroma_filter_graph(w, h, nbh, nbv, bw, bh, jnp.asarray(vis),
                                   j["mvx"], j["mvy"], j["flags"],
                                   i32(a["q"]))


def _native(kind, geo, vis, a, df=1, tmc=1, sharpen=1):
    w, h, nbh, nbv, bw, bh = geo
    ref = vis.copy()
    if kind == "intra":
        native.intra_filter(ref, w, h, w, a["bd"].reshape(-1), nbh, nbv,
                            a["fq"], a["fth"], 0, df)
        return ref
    mv = [np.ascontiguousarray(a[k].reshape(-1).astype(dt)) for k, dt in
          (("mvx", np.int16), ("mvy", np.int16), ("flags", np.uint32))]
    if kind == "luma":
        native.luma_filter(ref, w, h, w, *mv,
                           np.ascontiguousarray(a["sub"].reshape(-1)
                                                .astype(np.uint8)),
                           nbh, nbv, bw, bh, a["fq"], a["fth"], 0, df, tmc,
                           sharpen)
    else:
        native.chroma_filter(ref, w, h, w, *mv, nbh, nbv, bw, bh, a["q"], 0)
    return ref


# (w, h, nbh, nbv, bw, bh): block dims are the luma blocks for intra and
# luma, the chroma blocks for chroma
GEOS = {
    "intra": [(100, 62, 7, 4, 16, 16), (64, 48, 4, 3, 16, 16),
              (35, 21, 3, 2, 16, 16)],
    "luma": [(100, 62, 7, 4, 16, 16), (64, 48, 2, 2, 32, 32),
             (40, 24, 3, 2, 16, 16)],
    "chroma": [(50, 31, 7, 4, 8, 8), (32, 48, 4, 3, 8, 16),
               (25, 16, 7, 4, 4, 4), (48, 40, 3, 3, 16, 16)],
}
CASES = [(k, g) for k in filters.KINDS for g in GEOS[k]]
IDS = ["%s-%dx%d-b%dx%d" % (k, g[0], g[1], g[4], g[5]) for k, g in CASES]


@pytest.mark.parametrize("kind,geo", CASES, ids=IDS)
def test_plain_vs_native(kind, geo):
    for trial in range(2):
        vis, a = _case(kind, geo[0], geo[1], geo[2], geo[3],
                       trial * 97 + geo[0])
        want = _native(kind, geo, vis, a)
        assert_same(_port(kind, geo, vis, a), want, kind)


@pytest.mark.parametrize("df,tmc,sharpen", [(1, 1, 1), (0, 1, 1),
                                             (1, 0, 1), (1, 1, 0)])
def test_luma_modes_vs_native(df, tmc, sharpen):
    geo = (64, 48, 4, 3, 16, 16)
    vis, a = _case("luma", 64, 48, 4, 3, 7 + df + 2 * tmc + 4 * sharpen)
    assert_same(_port("luma", geo, vis, a, df, tmc, sharpen),
                _native("luma", geo, vis, a, df, tmc, sharpen))


@pytest.mark.parametrize("kind", filters.KINDS)
def test_plain_vs_xla(kind):
    geo = GEOS[kind][0]
    vis, a = _case(kind, *geo[:4], seed=11)
    assert_same(_port(kind, geo, vis, a), _jax(jfilters, kind, geo, vis, a))


@pytest.mark.parametrize("mode", ["vmem", "hbm"])
@pytest.mark.parametrize("kind", filters.KINDS)
def test_plain_vs_pallas(kind, mode, monkeypatch):
    """filters_pl in interpret mode; DSV2_PL_VMEM_CAP=1 forces its
    HBM-resident variant (the TPU kernel for >= 720p planes)."""
    if mode == "hbm":
        monkeypatch.setenv("DSV2_PL_VMEM_CAP", "1")
    geo = {"intra": (40, 28, 3, 2, 16, 16), "luma": (40, 28, 3, 2, 16, 16),
           "chroma": (24, 20, 3, 3, 8, 8)}[kind]
    vis, a = _case(kind, *geo[:4], seed=5)
    assert_same(_port(kind, geo, vis, a),
                _jax(filters_pl, kind, geo, vis, a))


@pytest.mark.parametrize("kind", filters.KINDS)
def test_batched_plain(kind):
    """Planes batched in one wavefront equal the same planes one by one,
    with per-plane scalars."""
    geo = GEOS[kind][1]
    w, h, nbh, nbv, bw, bh = geo
    ins = [_case(kind, w, h, nbh, nbv, 40 + i) for i in range(3)]
    one = [_port(kind, geo, vis, a) for vis, a in ins]
    vis = torch.stack([tt(v) for v, _ in ins])
    st = {k: torch.stack([tt(a[k]) for _, a in ins])
          for k in ins[0][1] if isinstance(ins[0][1][k], np.ndarray)}
    sc = {k: torch.tensor([a[k] for _, a in ins], dtype=torch.int32)
          for k in ("fq", "fth", "q") if k in ins[0][1]}
    if kind == "intra":
        got = filters.intra_filter_graph(w, h, nbh, nbv, vis, st["bd"],
                                         sc["fq"], sc["fth"])
    elif kind == "luma":
        got = filters.luma_filter_graph(w, h, nbh, nbv, bw, bh, 1, vis,
                                        st["mvx"], st["mvy"], st["flags"],
                                        st["sub"], sc["fq"], sc["fth"], 1, 1)
    else:
        got = filters.chroma_filter_graph(w, h, nbh, nbv, bw, bh, vis,
                                          st["mvx"], st["mvy"], st["flags"],
                                          sc["q"])
    assert_same(got, torch.stack(one))


def test_wavefront_rejects():
    lay = filters._layout(40, 28, 4, 4, 9, 6)
    plane = torch.zeros((1, lay.HP, lay.WP), dtype=torch.int32)
    props = torch.zeros((1, 1, lay.nty, lay.ntx), dtype=torch.int32)
    scal = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane.long(), props, scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("luma", lay, plane, props, scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("dering", lay, plane, props, scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane, props[:, :, :, :-1],
                                 scal)
    from dsv2_tpu_torch.utils import trace
    trace.reset()
    trace.enable(True)
    try:
        filters.wavefront_filter("intra", lay, plane, props, scal)
    finally:
        trace.enable(False)
    assert trace.counters() == {}   # CPU: no launch


def test_kernel_flag_bits():
    """The flag bits the CUDA source hard-codes are the format's."""
    src = open(os.path.join(REPO, "dsv2_tpu_torch", "csrc",
                            "wavefront_filter.cu")).read()
    defs = dict(re.findall(r"#define DSV2T_(\w+) (\d+)", src))
    assert len(defs) == 7
    for name, val in defs.items():
        assert getattr(K, name) == int(val), name
