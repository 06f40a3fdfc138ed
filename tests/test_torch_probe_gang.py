"""torch port: the gang cost probe's plain versions
(dsv2_tpu_torch/tools/probe_gang.py, what csrc/probe_gang.cu is held to
on the card) against a numpy statement of tools/probe_gang.py: the
window read (:55-68), the metric (:70-76), the per-block kernel
(:84-104), the ganged kernel (:129-159) and the computed-index load
(:184-191), at a small NB; plus the block/gang parity count of :224-228
(the gang's horizontal roll wraps across the 128-wide tile, and each
evaluation overwrites its sums). Tolerance: none, integers.
"""
import numpy as np
import pytest
import torch

from dsv2_tpu_torch.tools import probe_gang as pg

NB = 24          # 3 gangs of 8


def np_inputs(nb):
    rng = np.random.RandomState(7)
    plane = rng.randint(0, 256, (pg.HP, pg.WP), np.uint8)
    cx = rng.randint(8, pg.WP - 64, nb).astype(np.int32)
    cy = rng.randint(8, pg.HP - 64, nb).astype(np.int32)
    return plane, cx, cy


def np_read(plane, x, y):
    """:55-68: aligned overfetch + rolls == the window at the clipped
    coordinates."""
    hp, wp = plane.shape
    oh, ow = 64, 256
    yy, xx = np.clip(y, 0, hp - 16), np.clip(x, 0, wp - 16)
    ya = min((yy // 32) * 32, hp - oh)
    xa = min((xx // 128) * 128, wp - ow)
    big = plane[ya:ya + oh, xa:xa + ow]
    big = np.roll(big, (-(yy - ya)) % oh, 0)
    big = np.roll(big, (-(xx - xa)) % ow, 1)
    return big[:16, :16].astype(np.int32)


def np_metr(a, b):
    d = np.abs(a - b)
    xr = d + np.roll(d, (-1) % d.shape[1], 1)
    se = ((xr + np.roll(xr, (-1) % d.shape[0], 0)) + 2) >> 2
    return se * se + ((a - b) ** 2 << 1) + (((a >> 1) - (b >> 1)) ** 2)


def np_block(mode, plane, cx, cy, evals):
    out = np.zeros(len(cx), np.int32)
    for i in range(len(cx)):
        x, y = cx[i], cy[i]
        acc = np.int32(0)
        for _ in range(evals):
            w2 = (np_read(plane, x, y) if mode != "compute"
                  else plane[:16, :16].astype(np.int32) + x)
            if mode == "read":
                acc = acc + w2[0, 0]
            else:
                acc = acc + np_metr(w2, np.roll(w2, 1, 0)).sum(
                    dtype=np.int32)
        out[i] = acc
    return out


def np_gang(mode, plane, cx, cy, evals):
    g_ = pg.G
    col = np.arange(16 * g_)[None] // 16
    out = np.zeros(len(cx), np.int32)
    for it in range(len(cx) // g_):
        for _ in range(evals):
            if mode == "compute":
                # broadcast_to((16, 16) -> (16, 128)) does not trace in
                # the TPU tool; the 8-fold tile is what it meant
                w2 = np.tile(plane[:16, :16].astype(np.int32), (1, g_))
            else:
                w2 = np.concatenate([np_read(plane, cx[it * g_ + g],
                                             cy[it * g_ + g])
                                     for g in range(g_)], axis=1)
            if mode == "read":
                for g in range(g_):
                    out[it * g_ + g] = w2[0, 0]
            else:
                row = np_metr(w2, np.roll(w2, 1, 0)).sum(0, keepdims=True,
                                                         dtype=np.int32)
                for g in range(g_):
                    out[it * g_ + g] = np.where(col == g, row, 0).sum()
    return out


def np_scalar(plane):
    v = plane[:8, :128].astype(np.int32)
    return np.array([v[(v[0].sum() + i) % 8, 0] for i in range(128)],
                    np.int32)


def test_inputs_match_the_tool():
    plane, cx, cy = pg.inputs(NB)
    want = np_inputs(NB)
    for got, w in zip((plane, cx, cy), want):
        assert np.array_equal(got.numpy(), w)


@pytest.mark.parametrize("mode", pg.MODES)
@pytest.mark.parametrize("evals", [1, 3])
def test_probe_plain_vs_numpy(mode, evals):
    plane, cx, cy = pg.inputs(NB)
    npl, ncx, ncy = np_inputs(NB)
    for plain, ref in ((pg.block_plain, np_block), (pg.gang_plain, np_gang)):
        got = plain(mode, plane, cx, cy, evals)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref(mode, npl, ncx, ncy, evals)), \
            (plain.__name__, mode, evals)
    assert np.array_equal(pg.scalar_plain(plane).numpy(), np_scalar(npl))


def test_probe_parity_mismatch():
    """The parity line counts what tools/probe_gang.py:224-228 counts:
    with several evaluations every block differs (block adds the
    evaluations up, gang overwrites); with one evaluation they still
    differ, through the seams alone (each window's last column reads the
    next window's first)."""
    npl, ncx, ncy = np_inputs(NB)
    res = pg.run("cpu", reps=1, nb=NB, evals=3)
    want = int((np_block("full", npl, ncx, ncy, 3)
                != np_gang("full", npl, ncx, ncy, 3)).sum())
    assert res["parity_mismatch_blocks"] == want == NB
    one = (np_block("full", npl, ncx, ncy, 1)
           != np_gang("full", npl, ncx, ncy, 1))
    assert one.sum() > 0
    assert all(r["max_abs_err"] == 0 for r in res["probes"])
