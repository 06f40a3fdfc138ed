"""torch port: the vk chain kernel (csrc/vk_chain.cu), run on the host.

The kernel source, built by the host C++ compiler against the CUDA shim of
tests/torch_parity.py (each warp an OS thread running its lanes as
fibers) with csrc/vk_async.cuh replaced by VK_ASYNC_HOST (a bulk copy is a
memcpy done at once, an mbarrier a 64-bit word of arrivals, bytes and
phase), walks speculative chunks on every block, resolves them exactly
and writes every row; its output must equal ops/scan_pl.vk_chain_plain
bit for bit on the real CIF luma and chroma chains, on constant thr
(oscillations of both parities), on thr far above any vk (a climb that no
candidate meets), on runs of thr = 0 (the clamp), on edge ranges (s0 >=
nnz, s0 = 0, nnz = npad, ranges ending at chunk boundaries +-1) and on
random chains, for B in 1, 3, 16, 32, 33 and several chunk lengths,
warm-ups (0 included) and walkers per block. The resolve pass's counters
show both of its branches ran: chunks whose true start met a candidate,
and chunks re-walked. Only the card shows that nvcc takes the source and
how fast it runs (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import numpy as np
import pytest
import torch

from torch_parity import (I_, P_, _cxx, _finish, _host_source, _start_build,
                          _write_shim, assert_same, in_time, ptr)
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch import cli
from dsv2_tpu_torch.ops import _kernels, hzcc, scan_pl
from dsv2_tpu_torch.parallel import batch

VK_ASYNC_HOST = r"""
#pragma once
#include "cuda_shim.h"
namespace vka {
// a barrier word: pending arrivals (bits 0-15), expected arrivals (16-31),
// bytes announced and not landed (32-62), phase (63)
inline void bar_update(uint64_t* bar, uint64_t arrivals, int64_t bytes) {
  std::atomic_ref<uint64_t> w(*bar);
  uint64_t o = w.load(), n;
  do {
    uint64_t pend = o & 0xffff, cnt = (o >> 16) & 0xffff;
    int64_t tx = (int64_t)((o >> 32) & 0x7fffffff) + bytes;
    uint64_t ph = o >> 63;
    if (pend < arrivals || tx < 0) abort();
    pend -= arrivals;
    if (pend == 0 && tx == 0) {
      pend = cnt;
      ph ^= 1;
    }
    n = pend | (cnt << 16) | ((uint64_t)tx << 32) | (ph << 63);
  } while (!w.compare_exchange_weak(o, n));
}
inline void bar_init(uint64_t* bar, int count) {
  std::atomic_ref<uint64_t>(*bar).store((uint64_t)count * 0x10001u);
}
inline void bar_init_fence() {}
inline void bar_arrive(uint64_t* bar) { bar_update(bar, 1, 0); }
inline void bar_expect(uint64_t* bar, uint32_t bytes) {
  bar_update(bar, 1, bytes);
}
inline void bar_wait(uint64_t* bar, uint32_t parity) {
  while ((std::atomic_ref<uint64_t>(*bar).load() >> 63) == parity) {
    std::this_thread::yield();
    shim_swap(shim_w->lane[shim_w->cur].ctx, shim_w->main);
  }
}
// a copy lands in the block's shared memory; its size and both ends are
// 16-byte aligned
inline void check(const void* sm, const void* gm, uint32_t bytes) {
  const uint8_t* base = shim_smem();
  const uint8_t* p = (const uint8_t*)sm;
  if (((uintptr_t)sm | (uintptr_t)gm | bytes) & 15) abort();
  if (p < base || p + bytes > base + shim_w->cta->smem.size()) abort();
}
inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
  bar_update(bar, 0, -(int64_t)bytes);
}
}  // namespace vka
"""

# (chunk, warm-up, walkers per block)
PLANS = [(64, 0, 128), (64, 64, 32), (256, 128, 32), (256, 256, 128),
         (2048, 512, 128)]
NBS = [1, 3, 16, 32, 33]
NPAD = 4096


@pytest.fixture(scope="module")
def vk():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        _write_shim(d)
        with open(os.path.join(d, "vk_async.cuh"), "w") as f:
            f.write(VK_ASYNC_HOST)
        lib = _finish(*_start_build(_cxx(), d, "vk_chain",
                                    _host_source("vk_chain")))
        fn = lib.dsv2t_vk_chain
        fn.restype = I_
        fn.argtypes = [P_] * 5 + [I_] * 6 + [P_, P_]
        yield fn


def host_chain(fn, thr, s0, nnz, plan):
    """The host build's vkpre and resolve counters for one launch."""
    chunk, warmup, walkers = plan
    npad, nb = thr.shape
    out = torch.full((npad, nb), -7, dtype=torch.int32)
    scratch = torch.empty(_kernels.vk_scratch_bytes(npad, nb, chunk),
                          dtype=torch.uint8)
    stats = torch.zeros(5, dtype=torch.int32)
    rc = in_time(lambda: fn(ptr(thr), ptr(s0), ptr(nnz), ptr(out),
                            ptr(scratch), npad, nb, chunk, warmup, walkers,
                            7, ptr(stats), None))
    assert rc == 0
    return out, stats


def check(fn, thr, s0, nnz, plans=PLANS):
    """Every plan equals the plain version; returns each plan's counters
    (live chunks, chunks whose true start met a candidate, chunks
    re-walked, re-walks that met a candidate, rows re-walked)."""
    thr, s0, nnz = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
                    for a in (thr, s0, nnz))
    want = scan_pl.vk_chain_plain(thr, s0, nnz)
    out = []
    for plan in plans:
        got, stats = host_chain(fn, thr, s0, nnz, plan)
        assert_same(got, want, "vkpre %s" % (plan,))
        out.append(stats.tolist())
    return out


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("kind", golden.VK_KINDS)
def test_vk_host_vs_plain(vk, kind, nb):
    stats = check(vk, *golden.vk_case(kind, nb, NPAD))
    live, met, rewalked, rewalk_met, rows = np.sum(stats, axis=0)
    assert live == met + rewalked and rewalk_met <= rewalked
    if kind == "climb":   # every chunk after a chain's first is re-walked
        assert rewalked > 0 and rewalk_met == 0 and rows > 0


def cif_chains():
    """(thr, s0, nnz) of the 8-frame CIF chunk's luma and chroma planes at
    -qp=60 -gop=0, through the batched intra step on the CPU."""
    frames, meta = cli.read_y4m(golden.input_path("cif352x288_420_12f"))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=0),
                           device=torch.device("cpu"))
    ctx = batch._prep_chunk(enc, frames[:8])
    p = ctx["p"]
    xs, bds, qs = batch._chunk_inputs(enc, ctx)
    fn = batch._device_batch_fn(meta.width, meta.height, meta.subsamp,
                                p.blk_w, p.blk_h, p.lossless, p.do_psy,
                                ctx["analyze"])
    vs = fn(xs[0], xs[1], xs[2], bds, qs)[2]
    return [scan_pl.vk_chain_inputs(tuple(hzcc.scan_segments(
        *ctx["pcfg"].cdims[c])), vs[c]) for c in (0, 1)]


def test_vk_host_cif_chains(vk):
    """The real chains: both branches of the resolve pass run and, at the
    plan _kernels.vk_plan gives a CIF plane (256-row chunks, 256 rows of
    warm-up), most chunks' true start meets a candidate (591 of 662 luma
    chunks)."""
    (lt, ls, ln), (ct, cs, cn) = cif_chains()
    luma = check(vk, lt.numpy(), ls.numpy(), ln.numpy())
    check(vk, ct.numpy(), cs.numpy(), cn.numpy())
    live, met, rewalked, rewalk_met, rows = luma[PLANS.index(
        _kernels.vk_plan(*lt.shape))]
    assert met > 2 * rewalked > 0 and rewalk_met > 0, luma


def test_vk_host_single_chain_b1(vk):
    """B = 1, as the P paths launch it: one chain across many chunks."""
    (lt, ls, ln), _ = cif_chains()
    check(vk, lt[:, 3:4].numpy(), ls[3:4].numpy(), ln[3:4].numpy(),
          [(256, 256, 128), (1024, 256, 128)])


@pytest.mark.parametrize("args", [
    dict(npad=4098), dict(nb=257), dict(chunk=96), dict(chunk=16),
    dict(warmup=48), dict(chunk=16384, warmup=49152), dict(walkers=0),
    dict(shift=4)], ids=lambda a: "-".join("%s%d" % kv for kv in a.items()))
def test_vk_host_rejects(vk, args):
    """Arguments the kernel does not take return an error, launch
    nothing and write nothing."""
    a = dict(npad=4096, nb=2, chunk=256, warmup=0, walkers=128, shift=0)
    a.update(args)
    thr = torch.zeros(a["npad"] * a["nb"] + 8, dtype=torch.int32)
    s0 = torch.zeros(a["nb"], dtype=torch.int32)
    out = torch.full((a["npad"] * a["nb"],), -7, dtype=torch.int32)
    scratch = torch.empty(16, dtype=torch.uint8)
    rc = vk(thr.data_ptr() + a["shift"], ptr(s0), ptr(s0), ptr(out),
            ptr(scratch), a["npad"], a["nb"], a["chunk"], a["warmup"],
            a["walkers"], 7, None, None)
    assert rc != 0
    assert bool((out == -7).all())
