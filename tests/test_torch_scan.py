"""torch port: the on-device entropy scan (ops/scan_pl).

The vk chain's plain version is held against dsv2_tpu's Pallas chain
(`_vk_call`, interpret mode on the CPU) on live rows; make_scan_blob is
held against dsv2_tpu's make_scan_blob (bytes [0, nbytes), nbytes,
fallback) and against the native scan coder, on the cases of
tests/test_scan_pl.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsv2_tpu import native
from dsv2_tpu.ops import hzcc, scan_pl as jscan
from dsv2_tpu_torch.ops import scan_pl
from torch_parity import tt


def _segs(w, h):
    return tuple(hzcc.scan_segments(w, h))


def _chain_case(npad, nb, seed):
    rng = np.random.default_rng(seed)
    thr = rng.integers(0, 40, (npad, nb)).astype(np.int32)
    thr[rng.random((npad, nb)) < 0.3] = 0
    s0 = rng.integers(0, npad // 4, nb).astype(np.int32)
    nnz = np.maximum(s0, rng.integers(0, npad, nb)).astype(np.int32)
    nnz[0] = npad           # one chain runs to the end
    return thr, s0, nnz


@pytest.mark.parametrize("nb", [1, 3])
def test_vk_plain_vs_pallas(nb):
    npad = 4096
    thr, s0, nnz = _chain_case(npad, nb, seed=nb)
    got = scan_pl.vk_chain(tt(thr), tt(s0), tt(nnz)).numpy()
    fn = jscan._vk_call(npad)
    if nb == 1:
        want = np.asarray(fn(jnp.asarray(thr[:, 0]), jnp.int32(s0[0]),
                             jnp.int32(nnz[0])))[:, None]
    else:   # batched chains run as vector lanes of one kernel pass
        want = np.asarray(jax.vmap(fn)(jnp.asarray(thr.T), jnp.asarray(s0),
                                       jnp.asarray(nnz))).T
    assert got.dtype == np.int32 and got.shape == (npad, nb)
    for b in range(nb):
        live = slice(s0[b], nnz[b])
        np.testing.assert_array_equal(got[live, b], want[live, b])
        # the port defines every row: 0 below s0, the final vk above nnz
        assert not got[:s0[b], b].any()
        final = got[nnz[b] - 1, b] if nnz[b] > s0[b] else 0
        step = 0 if nnz[b] <= s0[b] else (
            1 if final < thr[nnz[b] - 1, b] else (-1 if final > 0 else 0))
        assert (got[nnz[b]:, b] == final + step).all()


def test_vk_plain_reference_loop():
    thr, s0, nnz = _chain_case(2048, 4, seed=9)
    got = scan_pl.vk_chain_plain(tt(thr), tt(s0), tt(nnz)).numpy()
    for b in range(4):
        vk = 0
        for i in range(2048):
            assert got[i, b] == vk
            if s0[b] <= i < nnz[b]:
                vk = vk + 1 if vk < thr[i, b] else max(vk - 1, 0)


def test_vk_chain_checks():
    thr = torch.zeros((8, 2), dtype=torch.int32)
    s0 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        scan_pl.vk_chain(thr.long(), s0, s0)
    with pytest.raises(ValueError):
        scan_pl.vk_chain(thr, s0[:1], s0)
    with pytest.raises(ValueError):
        scan_pl.vk_chain(thr.T, s0, s0)


def _check(segs, vs, cap=None, with_jax=True):
    """Port blob vs native (and the JAX twin) for scan arrays vs (B,
    total); every plane must stay inside the blob contract."""
    vs = np.atleast_2d(np.asarray(vs, np.int32))
    total = sum(c for c, _ in segs)
    cap = cap or 2 * total
    blob, n, fb = scan_pl.make_scan_blob(segs, cap)(tt(vs))
    assert blob.dtype == torch.uint8 and n.dtype == torch.int32
    assert blob.shape == (vs.shape[0], cap)
    jf = jscan.make_scan_blob(segs, cap) if with_jax else None
    for i, v in enumerate(vs):
        assert not bool(fb[i])
        got = blob[i, :int(n[i])].numpy().tobytes()
        assert got == native.scan_encode(v, list(segs))
        if jf is not None:
            jb, jn, jfb = jf(jnp.asarray(v))
            assert int(jn) == int(n[i]) and not bool(jfb)
            assert np.asarray(jb)[:int(jn)].tobytes() == got


@pytest.mark.parametrize("w,h", [(176, 144), (100, 62), (64, 48)])
def test_random_sparse(w, h):
    rng = np.random.default_rng(42)
    segs = _segs(w, h)
    total = sum(c for c, _ in segs)
    ll_n = segs[0][0]
    vs = []
    for density in (0.01, 0.1, 0.5, 1.0):
        v = np.zeros(total, np.int32)
        nz = rng.random(total) < density
        v[nz] = rng.integers(-127, 128, nz.sum())
        v[:ll_n] = (rng.integers(-60000, 60000, ll_n)
                    * (rng.random(ll_n) < 0.7))
        vs.append(v)
    _check(segs, vs, with_jax=(w, h) == (100, 62))


def test_edges():
    segs = _segs(176, 144)
    total = sum(c for c, _ in segs)
    ll_n = segs[0][0]
    vs = [np.zeros(total)]                             # empty blob
    v = np.zeros(total); v[-1] = 100; vs.append(v)     # max-length run
    v = np.zeros(total); v[0] = -(2 ** 29); vs.append(v)
    v = np.full(total, 127); v[:ll_n] = 2 ** 29 - 1; vs.append(v)
    v = np.full(total, -127); v[:ll_n] = -(2 ** 29); vs.append(v)
    # vk climb on a dense stretch, then decay over sparse tail
    v = np.zeros(total)
    v[ll_n:ll_n + 5000] = 127
    v[ll_n + 20000::501] = -1
    vs.append(v)
    # tiny values keep k at 0 (rice '1'-bit tails)
    v = np.zeros(total); v[ll_n::7] = 1; vs.append(v)
    _check(segs, vs)


def test_fallbacks():
    segs = _segs(176, 144)
    total = sum(c for c, _ in segs)
    ll_n = segs[0][0]
    rng = np.random.default_rng(0)
    vs = np.zeros((4, total), np.int32)
    vs[0, ll_n + 10] = 128                        # HF over int8
    vs[1, 0] = 2 ** 30                            # LL over 2^30
    vs[2, ll_n + 10] = 2 ** 31 - 1                # wrapping bit offsets
    vs[2, ll_n + 11] = -(2 ** 31)
    vs[3, ll_n:] = rng.integers(-127, 128, total - ll_n)   # in contract
    _, _, fb = scan_pl.make_scan_blob(segs, 2 * total)(tt(vs))
    assert fb.tolist() == [True, True, True, False]
    jf = jscan.make_scan_blob(segs, 2 * total)
    assert [bool(jf(jnp.asarray(v))[2]) for v in vs] == fb.tolist()
    small = scan_pl.make_scan_blob(segs, 64)                 # cap exceeded
    assert scan_pl.make_scan_blob(segs, 64)(tt(vs[3:]))[2].tolist() == [True]
    assert small(tt(np.zeros((1, total), np.int32)))[2].tolist() == [False]


def test_batch():
    rng = np.random.default_rng(3)
    segs = _segs(100, 62)
    total = sum(c for c, _ in segs)
    vs = []
    for i in range(4):
        v = np.zeros(total, np.int32)
        nz = rng.random(total) < (0.02 + 0.1 * i)
        v[nz] = rng.integers(-127, 128, nz.sum())
        vs.append(v)
    _check(segs, vs, cap=total)


def test_codec_statistics():
    """Blob parity under codec-like statistics: laplacian values whose
    density and magnitude decay by subband level, across seeds to sweep
    vk trajectories."""
    segs = _segs(176, 144)
    ll_n = segs[0][0]
    vs = []
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        parts = [np.round(rng.laplace(0, 900, ll_n)).astype(np.int32)]
        for count, damp in segs[1:]:
            scale = 0.5 * (damp - 2)        # sparser/higher by level
            vals = np.round(rng.laplace(0, scale, count))
            parts.append(np.clip(vals, -127, 127).astype(np.int32))
        vs.append(np.concatenate(parts))
    _check(segs, vs, with_jax=False)


def test_chain_inputs_match_blob_path():
    segs = _segs(64, 48)
    total = sum(c for c, _ in segs)
    rng = np.random.default_rng(11)
    v = (rng.integers(-5, 6, (2, total))
         * (rng.random((2, total)) < 0.2)).astype(np.int32)
    thr, s0, nnz = scan_pl.vk_chain_inputs(segs, tt(v))
    assert thr.dtype == torch.int32 and thr.is_contiguous()
    assert nnz.tolist() == (v != 0).sum(axis=1).tolist()
    assert s0.tolist() == (v[:, :segs[0][0]] != 0).sum(axis=1).tolist()
