"""On-device entropy scan: the plane coefficient blob built with torch.

Port of `dsv2_tpu/ops/scan_pl.py` (ref: hzcc.c:234-448; RUN_BITS framing
in dsv2_tpu/native/dsv2n.c scan_dense8_bw). The device produces each
plane's FINAL scan blob, so the device-to-host payload is the
entropy-coded size and the host serializer is a memcpy.

Blob layout (byte-aligned at both ends, drop-in for the native coder's
output):

  [24-bit nruns][codes...][align to byte]

Per nonzero coefficient, in scan order:
  - UEG(run): for run+1 with leading bit dropped, bits interleaved with
    zeros, terminating 1 — length 2*nb+1;
  - value: LL segment (damp < 0) NEG = UEG(|v|-1) + sign bit; HF segments
    adaptive rice: q zero bits, a 1, then k = vk>>damp low bits of u-1
    (u the zigzag-folded value), with vk adapting by +-1 on q != 0.

Everything is plain data-parallel torch over a leading frame dimension
except the vk adaptation chain, a strictly sequential recurrence over the
nonzero values: `vk_chain` runs it as the hand-written CUDA kernel
`csrc/vk_chain.cu` on a CUDA tensor, and as its plain version on a CPU
tensor.

Emission differs in form from the twin but not in bytes. Each code is at
most two parts of <= 63 bits, each carried in one int64 (torch has few
uint32 ops). A part at bit offset s touches at most three consecutive
big-endian 32-bit words of the stream; all parts' word contributions go
to the word buffer in one scatter-add (bits never overlap across codes,
and rice's q zero-gap bits are never written, so add == or); those that
carry no bits add 0 to words spread over the row, so that no word takes
the atomic adds of every dead slot. The twin's
dynamically bounded chunk loops become one pass over all padded slots
with a live mask, so nothing on the device path reads a value back to
the host.

The device blob targets the dense8 contract (|HF| <= 127, |LL| < 2^30);
anything outside it, a blob over the byte capacity, or >= 2^24 runs
raises the fallback flag and the host redoes that plane natively.
"""
import functools

import numpy as np
import torch

from ..utils import trace
from . import tint

RUN_BITS = 24
_RCH_MIN = 1 << 11   # vk row granularity; the padded slot count is a multiple
_I32, _I64 = torch.int32, torch.int64


def _pad_to(n, m):
    return -(-n // m) * m


def _chunk_sizes(total, ll_n):
    """(cll, chf, TP) for a plane with `total` scan positions and an
    `ll_n`-wide LL NEG prefix, as in the twin. Only TP — the compacted
    slot padding, a multiple of the vk row granularity — shapes the torch
    path; cll and chf were the twin's emission chunk sizes."""
    chf = max(_RCH_MIN,
              min(1 << 16, 1 << (max(total // 16, 1) - 1).bit_length()))
    cll = max(8, min(chf, 1 << (max(ll_n, 1) - 1).bit_length()))
    tp = _pad_to(max(total, chf), chf)
    return cll, chf, tp


def _damp_of_pos(segments, pos):
    """damp as an elementwise piecewise-constant of the scan position
    (segments is a short static tuple)."""
    out = torch.full_like(pos, segments[-1][1])
    ends = np.cumsum([c for c, _ in segments])
    for j in range(len(segments) - 2, -1, -1):
        out = torch.where(pos < int(ends[j]), segments[j][1], out)
    return out


# ---------------------------------------------------------------------------
# the vk adaptation chain (sequential): CUDA kernel + plain version
# ---------------------------------------------------------------------------

def _check_chain_args(thr, s0, nnz):
    if thr.dim() != 2 or s0.shape != (thr.shape[1],) \
            or nnz.shape != (thr.shape[1],):
        raise ValueError("vk_chain wants thr (npad, B), s0 (B,), nnz (B,); "
                         "got %s, %s, %s" % (tuple(thr.shape),
                                             tuple(s0.shape),
                                             tuple(nnz.shape)))
    for t in (thr, s0, nnz):
        if t.dtype != _I32:
            raise TypeError("vk_chain wants int32 tensors, got %s" % t.dtype)
        if t.device != thr.device:
            raise ValueError("vk_chain tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("vk_chain wants contiguous tensors")


def vk_chain_plain(thr, s0, nnz):
    """Plain version of the vk chain, on the host: thr (npad, B) int32
    time-major, s0/nnz (B,) int32 -> vkpre (npad, B) int32 on thr's
    device. Chain b walks rows [s0_b, nnz_b) in order, storing the
    PRE-update vk, then vk <- vk+1 if vk < thr else max(vk-1, 0). Every
    row is defined: 0 below s0, the final vk at and above nnz."""
    _check_chain_args(thr, s0, nnz)
    npad, nb = thr.shape
    t = thr.cpu().numpy()
    lo_all = np.clip(s0.cpu().numpy(), 0, npad)
    hi_all = np.clip(nnz.cpu().numpy(), 0, npad)
    out = np.zeros((npad, nb), dtype=np.int32)
    for b in range(nb):
        lo = int(lo_all[b])
        hi = max(int(hi_all[b]), lo)
        vk = 0
        pre = []
        for x in t[lo:hi, b].tolist():
            pre.append(vk)
            vk = vk + 1 if vk < x else max(vk - 1, 0)
        out[lo:hi, b] = pre
        out[hi:, b] = vk
    return torch.from_numpy(out).to(thr.device)


def vk_chain(thr, s0, nnz, stats=None):
    """The rice vk chain of B planes at once: thr (npad, B) int32
    time-major, s0/nnz (B,) int32 -> vkpre (npad, B) int32 (semantics in
    vk_chain_plain). thr pre-bakes the adaptation compare: e >= (vk >> d)
    <=> vk < (e+1) << d =: thr, so the sequential body is one load, one
    store and a three-op dependent chain.

    A CUDA tensor launches csrc/vk_chain.cu on the current stream (and
    counts the launch as `launch.vk_chain`, utils/trace; `stats`, an
    int32 (5,) CUDA tensor, gets its resolve pass's counters added, see
    _kernels.vk_chain); a CPU tensor takes the plain version. Replaces
    the twin's _vk_call / _vk_vec_batched."""
    _check_chain_args(thr, s0, nnz)
    if thr.device.type == "cpu":
        return vk_chain_plain(thr, s0, nnz)
    if thr.device.type != "cuda":
        raise ValueError("vk_chain runs on cuda or cpu, not %s" % thr.device)
    from . import _kernels
    npad, nb = thr.shape
    m = _kernels.VK_MAX_CHAINS
    if nb > m:   # a launch takes at most m chains
        return torch.cat([vk_chain(thr[:, i:i + m].contiguous(),
                                   s0[i:i + m].contiguous(),
                                   nnz[i:i + m].contiguous(), stats)
                          for i in range(0, nb, m)], dim=1)
    n4 = _pad_to(npad, 4)
    if n4 != npad or thr.data_ptr() % 16:
        # the kernel's bulk copies take rows in fours from a 16-byte
        # aligned base; the padding rows lie past every chain's nnz
        thr = torch.cat([thr, thr.new_zeros((n4 - npad, nb))])
        nnz = torch.clamp(nnz, max=npad)
    plan = _kernels.vk_plan(n4, nb)
    out = torch.empty((n4, nb), dtype=_I32, device=thr.device)
    scratch = torch.empty(_kernels.vk_scratch_bytes(n4, nb, plan[0]),
                          dtype=torch.uint8, device=thr.device)
    _kernels.vk_chain(thr, s0, nnz, out, scratch, *plan, stats=stats)
    trace.count("launch.vk_chain")
    return out[:npad]


# ---------------------------------------------------------------------------
# code-pattern construction (vectorized, int64 carriers)
# ---------------------------------------------------------------------------

def _spread(x):
    """Interleave zeros below each bit: bit i of x -> bit 2i (x < 2^32)."""
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    x = (x | (x << 1)) & 0x5555555555555555
    return x


def _ueg_pattern(v):
    """UEG code for v >= 0 (int32, v < 2^31 - 1): (pattern int64, len
    int32). Bitstring [0 b_{nb-1} 0 b_{nb-2} ... 0 b_0 1], nb =
    ilog2(v+1); as an integer (LSB = last bit): spread(x without its
    leading bit) << 1 | 1, len = 2*nb+1 <= 63."""
    x = v + 1
    nb = tint.ilog2(x)
    body = x.to(_I64) ^ (torch.ones_like(x, dtype=_I64)
                         << torch.clamp(nb, 0, 31).to(_I64))
    return (_spread(body) << 1) | 1, 2 * nb + 1


def _neg_pattern(v):
    """NEG code for v != 0 (|v| < 2^30): UEG(|v|-1) then the sign bit."""
    p, ln = _ueg_pattern(v.abs() - 1)
    return (p << 1) | (v < 0).to(_I64), ln + 1


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def _part_words(s, ln, pat, live, spill):
    """Big-endian u32 word contributions of one code part: s (bit offset),
    ln (length <= 63) int32, pat int64 (bit ln-1 goes first). Returns
    (word index, value) pairs, each (..., 3*n): the three words starting
    at s >> 5. A contribution that carries no bits (a dead part's, or a
    live part's word past its end) adds 0 to word spill[m] instead
    (spill (3, n) int32, words spread over the row)."""
    o = (s & 31).to(_I64)
    end = o + ln.to(_I64)                 # part spans window bits [o, end)
    w0 = s >> 5
    idx, val = [], []
    for m in range(3):
        sh = end - 32 * (m + 1)           # >> sh if >= 0, else << -sh
        right = pat >> torch.clamp(sh, 0, 63)
        left = pat << torch.clamp(-sh, 0, 63)
        word = torch.where(sh >= 0, right, left) & 0xFFFFFFFF
        hit = live & (end > 32 * m)
        idx.append(torch.where(hit, w0 + m, spill[m]))
        val.append(torch.where(hit, word, 0))
    return torch.cat(idx, dim=-1), torch.cat(val, dim=-1)


def _slot_targets(nz, at):
    """Stable 0/1 partition of nz (B, total) bool as a cumsum scatter (at
    = arange(total) int32): -> (nruns (B,) int32, tgt (B, total) int64).
    Nonzero i goes to slot rank(i), zero i behind the nonzeros, to nruns
    + (its rank among the zeros), so every position has a slot of its
    own below total."""
    nruns = nz.sum(dim=-1, dtype=_I32)
    rank = torch.cumsum(nz, dim=-1, dtype=_I32) - 1
    return nruns, torch.where(nz, rank, (nruns - 1)[:, None] + at - rank
                              ).to(_I64)


def _slots(segments, v, TP):
    """Compaction and per-slot code quantities of scan arrays v (B, total)
    int32: the nonzeros stable-partitioned to the front of TP slots, the
    zeros behind them. The slots from nruns on are dead: every later use
    masks them (act, isneg, isr), whatever pos they hold."""
    nb, total = v.shape
    ll_n = segments[0][0] if segments and segments[0][1] < 0 else 0
    nz = v != 0
    nll = nz[:, :ll_n].sum(dim=-1, dtype=_I32)
    at = torch.arange(total, dtype=_I32, device=v.device)
    nruns, tgt = _slot_targets(nz, at)
    # slots below total are all written; only the padding is zeroed
    vals = torch.empty((nb, TP), dtype=_I32, device=v.device)
    pos = torch.empty((nb, TP), dtype=_I32, device=v.device)
    vals[:, total:] = 0
    pos[:, total:] = 0
    vals.scatter_(1, tgt, v)
    pos.scatter_(1, tgt, at.expand(nb, total))
    act = torch.arange(TP, dtype=_I32, device=v.device) < nruns[:, None]
    dmp = _damp_of_pos(segments, pos)
    isneg = act & (dmp < 0)
    isr = act & (dmp >= 0)
    # zigzag fold u and e = ilog2(u-1) for the rice elements
    u = torch.where(vals >= 0, 2 * vals, -2 * vals - 1)
    um1 = torch.clamp(u - 1, min=0)
    e = tint.ilog2(um1)
    dsafe = torch.clamp(dmp, min=0)
    thr = torch.where(isr, (e + 1) << dsafe, 0)
    return dict(nruns=nruns, nll=nll, vals=vals, pos=pos, act=act,
                isneg=isneg, isr=isr, um1=um1, dsafe=dsafe, thr=thr)


def _tp(segments):
    """The padded slot count TP of a plane's scan."""
    total = sum(c for c, _ in segments)
    ll_n = segments[0][0] if segments and segments[0][1] < 0 else 0
    return _chunk_sizes(total, ll_n)[2]


def vk_chain_inputs(segments, v):
    """The vk chain's (thr (npad, B), s0 (B,), nnz (B,)) for scan arrays
    v (B, total) int32, exactly as make_scan_blob hands them over."""
    segments = tuple(segments)
    st = _slots(segments, v, _tp(segments))
    return st["thr"].T.contiguous(), st["nll"], st["nruns"]


def emission(segments, cap_bytes, v):
    """The codes of scan arrays v (B, total) int32 as word contributions
    to a blob of cap_bytes: (idx int64 (B, 6*TP) into Mw + 1 words, Mw =
    the blob's 32-bit words, val int64 (B, 6*TP), nruns int32 (B,),
    nbytes int32 (B,), fallback bool (B,)). Word Mw is a sink, dropped;
    a contribution that carries bits goes to its word, or to the sink
    past the blob (only fallback planes get there: there q can be
    ~2^31 and the int32 offsets wrap, as they do in the twin). One that
    carries none adds 0, to its own column modulo Mw, so no word takes
    more than ceil(6*TP / Mw) of those."""
    TP = _tp(segments)
    Mw = _pad_to(cap_bytes, 4) // 4
    st = _slots(segments, v, TP)
    nruns, act, isneg, isr = st["nruns"], st["act"], st["isneg"], st["isr"]
    vals, pos, um1, dsafe = st["vals"], st["pos"], st["um1"], st["dsafe"]

    # contract guards -> host fallback
    bad_hf = isr & (vals.abs() > 127)
    bad_ll = isneg & (vals.abs() >= (1 << 30))
    fallback = bad_hf.any(dim=-1) | bad_ll.any(dim=-1)

    # vk chain (sequential) -> per-element rice k (pre-update vk)
    vkpre = vk_chain(st["thr"].T.contiguous(), st["nll"], nruns).T
    k = torch.clamp(torch.clamp(vkpre, min=0) >> dsafe, 0, 30)

    # part A: UEG(run); run = pos diff - 1 (pos[-1] == -1)
    prev = torch.cat([torch.full_like(pos[:, :1], -1), pos[:, :-1]], -1)
    run = torch.where(act, pos - prev - 1, 0)
    apat, alen = _ueg_pattern(run)

    # part B: NEG, or the rice tail [1][k bits of u-1] after q zeros
    npat, nlen = _neg_pattern(torch.where(isneg, vals, 1))
    q = um1 >> k
    k64 = k.to(_I64)
    one = torch.ones_like(k64)
    rpat = (one << k64) | (um1.to(_I64) & ((one << k64) - 1))
    bpat = torch.where(isneg, npat, rpat)
    blen = torch.where(isneg, nlen, 1 + k)
    bgap = torch.where(isneg, 0, q)                # zeros before B

    # bit offsets: part A at sa, part B at sa + alen + bgap
    tot_i = torch.where(act, alen + bgap + blen, 0)
    sa = RUN_BITS + torch.cumsum(tot_i, dim=-1, dtype=_I32) - tot_i
    sb = sa + alen + bgap
    last = torch.clamp(nruns - 1, min=0).to(_I64)[:, None]
    end_bits = torch.where(
        nruns > 0,
        (sb.gather(1, last) + blen.gather(1, last))[:, 0], RUN_BITS)
    nbytes = torch.div(end_bits + 7, 8, rounding_mode="floor")
    fallback = fallback | (nbytes > cap_bytes) | (nruns >= (1 << RUN_BITS))

    # every part's word contributions
    spill = torch.remainder(torch.arange(6 * TP, dtype=_I32,
                                         device=v.device), Mw).view(6, TP)
    ia, va = _part_words(sa, alen, apat, act, spill[:3])
    ib, vb = _part_words(sb, blen, bpat, act, spill[3:])
    idx = torch.cat([ia, ib], dim=-1)
    idx = torch.where((idx >= 0) & (idx < Mw), idx, Mw).to(_I64)
    return idx, torch.cat([va, vb], dim=-1), nruns, nbytes, fallback


@functools.lru_cache(maxsize=None)
def make_scan_blob(segments, cap_bytes):
    """fn(v int32[B, total]) -> (blob uint8[B, cap_bytes], nbytes
    int32[B], fallback bool[B]). segments: tuple of (count, damp) as in
    hzcc.scan_segments. Blob bytes [0, nbytes) byte-match the native scan
    encoder's; on fallback the caller must host-encode instead."""
    total = sum(c for c, _ in segments)
    Mb = cap_bytes
    Mw = _pad_to(Mb, 4) // 4

    def f(v):
        if v.dtype != _I32 or v.dim() != 2 or v.shape[1] != total:
            raise ValueError("scan arrays must be int32 (B, %d), got %s %s"
                             % (total, v.dtype, tuple(v.shape)))
        idx, val, nruns, nbytes, fallback = emission(segments, Mb, v)
        # every contribution in one scatter-add (add == or: no two
        # contributions share a bit)
        words = torch.zeros((v.shape[0], Mw + 1), dtype=_I64,
                            device=v.device)
        words.scatter_add_(1, idx, val)
        words = words[:, :Mw]
        blob = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                           dim=-1).to(torch.uint8).reshape(v.shape[0], -1)
        blob = blob[:, :Mb].contiguous()
        blob[:, 0] = (nruns >> 16).to(torch.uint8)
        blob[:, 1] = ((nruns >> 8) & 0xFF).to(torch.uint8)
        blob[:, 2] = (nruns & 0xFF).to(torch.uint8)
        return blob, nbytes.to(_I32), fallback

    return f
