"""torch port: the gang cost probe's plain versions
(dsv2_tpu_torch/tools/probe_gang.py, what csrc/probe_gang.cu is held to
on the card) against a numpy statement of tools/probe_gang.py: the
window read (:55-68), the metric (:70-76), the per-block kernel
(:84-104), the ganged kernel (:129-159) and the computed-index load
(:184-191), at a small NB; plus the block/gang parity count of :224-228
(the gang's horizontal roll wraps across the 128-wide tile, and each
evaluation overwrites its sums). The kernel's launch shape
(launch_shape: every block in exactly one warp's work, the gang tail in
none, walkers=1 one warp of one CTA) for NB in 1, 7, 8, 16, 701, 704 on
1 and 132 SMs. And the kernel source itself, built by the host C++
compiler against the CUDA shim of tests/torch_parity.py (each warp an OS
thread running its lanes as fibers; csrc/cp_async.cuh replaced by
CP_ASYNC_HOST, whose copies land only at the wait that must cover
them), against the plain versions at both launch shapes and more.
Tolerance: none, integers.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from torch_parity import (I_, P_, _cxx, _finish, _host_source, _start_build,
                          _write_shim, in_time, ptr)
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


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("nb", [1, 7, 8, 16, 701, 704])
def test_launch_shape(nb, sms):
    """Every block (gang slot) in exactly one warp's work, in order
    within a warp; none past nb, none in the gang tail; CTAs of at most
    MAX_WARPS warps, none empty; walkers=0 a warp per unit on min(units,
    sms) CTAs; walkers=1 one CTA of one warp over every block in order."""
    for variant in pg.VARIANTS:
        units = nb if variant == "block" else nb // pg.G
        for walkers in (0, 1, 3, 2000):
            sh = pg.launch_shape(nb, variant, walkers, sms)
            assert sh.units == units
            if units == 0:
                assert sh == (0, 0, 0)
                continue
            assert 1 <= sh.ctas <= units
            assert 1 <= sh.warps <= pg.MAX_WARPS[variant]
            blocks = []
            for k in range(sh.ctas):
                assert len(sh.cta_units(k)) > 0
                for w in range(sh.warps):
                    us = list(sh.warp_units(k, w))
                    assert us == sorted(us)
                    if walkers == 0:
                        assert len(us) <= 1
                    blocks += [b for u in us
                               for b in pg.unit_blocks(variant, u)]
            assert sorted(blocks) == list(range(units * (
                1 if variant == "block" else pg.G)))
            assert max(blocks) < nb
            if walkers == 0:
                assert sh.ctas == min(units, sms) or sh.warps == \
                    pg.MAX_WARPS[variant]
            if walkers == 1:
                assert (sh.ctas, sh.warps) == (1, 1)
                assert list(sh.warp_units(0, 0)) == list(range(units))


CP_ASYNC_HOST = r"""
#pragma once
#include <vector>
#include "cuda_shim.h"
namespace cpa {
// a lane's copies by group: a group lands only at the wait that must
// cover it (a read before that sees the shim's 0xCD fill)
struct Copy {
  void* dst;
  const void* src;
  int bytes;
};
struct Pending {
  std::vector<std::vector<Copy>> groups;
  std::vector<Copy> open;
};
inline thread_local Pending pending[32];  // a warp's lanes (one OS thread)
inline void copy16(void* dst, const void* src, int bytes) {
  const uint8_t* base = shim_smem();
  const uint8_t* p = (const uint8_t*)dst;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) || bytes < 0 || bytes > 16)
    abort();
  if (p < base || p + 16 > base + shim_w->cta->smem.size()) abort();
  pending[shim_w->cur].open.push_back({dst, src, bytes});
}
inline void commit() {
  Pending& l = pending[shim_w->cur];
  l.groups.push_back(std::move(l.open));
  l.open.clear();
}
inline void wait1() {
  Pending& l = pending[shim_w->cur];
  while (l.groups.size() > 1) {
    for (const Copy& c : l.groups.front()) {
      std::memset(c.dst, 0, 16);
      std::memcpy(c.dst, c.src, c.bytes);
    }
    l.groups.erase(l.groups.begin());
  }
}
}  // namespace cpa
"""


@pytest.fixture(scope="module")
def host_probe(tmp_path_factory):
    """csrc/probe_gang.cu built for the host against the shim."""
    d = str(tmp_path_factory.mktemp("probe_host"))
    cxx = _cxx()
    _write_shim(d)
    with open(os.path.join(d, "cp_async.cuh"), "w") as f:
        f.write(CP_ASYNC_HOST)
    fn = _finish(*_start_build(cxx, d, "probe_gang",
                               _host_source("probe_gang"))).dsv2t_probe_gang
    fn.restype = I_
    fn.argtypes = [I_, I_, P_, P_, P_, P_] + [I_] * 6 + [P_]
    return fn


def host_run(fn, variant, mode, plane, cx, cy, evals, shape):
    nb = cx.shape[0]
    out = torch.zeros(128 if variant == "scalar" else nb, dtype=torch.int32)
    hp, wp = plane.shape
    rc = in_time(lambda: fn(
        (*pg.VARIANTS, "scalar").index(variant), pg.MODES.index(mode),
        ptr(plane), ptr(cx), ptr(cy), ptr(out), nb, evals, hp, wp,
        shape.ctas, shape.warps, None), 120)
    assert rc == 0
    return out


@pytest.mark.parametrize("nb,walkers,sms", [(16, 0, 132), (16, 1, 132),
                                            (37, 0, 4), (37, 3, 132)])
def test_probe_kernel_host(host_probe, nb, walkers, sms):
    """The kernel source (host build) equals the plain versions in every
    mode: a warp per unit, one walker, several units per warp (3
    walkers over 37 blocks: a restaged double buffer), a gang tail."""
    plane, cx, cy = pg.inputs(nb)
    assert plane.data_ptr() % 16 == 0
    for variant, plain in (("block", pg.block_plain),
                           ("gang", pg.gang_plain)):
        shape = pg.launch_shape(nb, variant, walkers, sms)
        for mode in pg.MODES:
            got = host_run(host_probe, variant, mode, plane, cx, cy, 2, shape)
            assert torch.equal(got, plain(mode, plane, cx, cy, 2)), \
                (variant, mode, shape)
    got = host_run(host_probe, "scalar", "full", plane, cx, cy, 0,
                   pg.Shape(0, 0, 0))
    assert torch.equal(got, pg.scalar_plain(plane))


def test_probe_kernel_host_edges(host_probe):
    """Windows at the plane's corners (clipped; the last row's second
    chunk past the plane's end, zero-filled and never read), negative
    and large coordinates, block/compute's x added, and the entry's
    refusals: a width not a multiple of 16, a shape with no warp."""
    plane, _, _ = pg.inputs(8)
    cx = torch.tensor([-5, 0, pg.WP - 16, pg.WP + 40, 3, 1000, 17, 250],
                      dtype=torch.int32)
    cy = torch.tensor([-9, pg.HP - 16, pg.HP + 3, 0, pg.HP - 17, 7, 500, 33],
                      dtype=torch.int32)
    for variant, plain in (("block", pg.block_plain),
                           ("gang", pg.gang_plain)):
        for walkers in (0, 1):
            shape = pg.launch_shape(8, variant, walkers, 132)
            for mode in pg.MODES:
                got = host_run(host_probe, variant, mode, plane, cx, cy, 3,
                               shape)
                assert torch.equal(got, plain(mode, plane, cx, cy, 3)), \
                    (variant, mode, walkers)
    out = torch.zeros(8, dtype=torch.int32)
    narrow = plane[:, :pg.WP - 8].contiguous()
    for args in ((narrow, pg.WP - 8, 8, 1), (plane, pg.WP, 0, 1),
                 (plane, pg.WP, 8, 0), (plane, pg.WP, 8, 33)):
        p, wp, ctas, warps = args
        assert host_probe(0, 0, ptr(p), ptr(cx), ptr(cy), ptr(out), 8, 1,
                          pg.HP, wp, ctas, warps, None) != 0
