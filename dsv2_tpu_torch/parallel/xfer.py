"""Device->host transfer of the coded planes (blob format).

Port of the blob half of `dsv2_tpu/parallel/xfer.py`. On the device every
plane's FINAL entropy-coded scan blob (ops/scan_pl) is merged into one
flat byte buffer, and the host fetches the occupied prefix with one copy
into pinned memory — entropy-coded size on the wire, and the host
serializer is a memcpy. The twin's "dense" and "packed" formats are not
ported (ROADMAP, "Not to port"): they exist for slow device links, a
card's host link is not one, and every format gives the same bytes.
Per-plane content outside the blob contract still falls back to the
int32 scan and the native host coder (codec semantics, not a device
fallback).

Every wait of the host for the card goes through `_sync` here: a blocking
read (`host`, `scalar`, `finish_d2h`) or a stream wait (`wait_stream`).
Each opens a `sync` span and counts `sync` (utils/trace) when tracing;
on CPU tensors nothing waits and nothing is recorded. Uploads go through
pinned memory (`upload`) and never wait.
"""
import torch

from ..utils import trace

_I32 = torch.int32


def _sync():
    """The span of one host-device wait, counted (credited to the span
    the wait happens in)."""
    trace.count("sync")
    return trace.stage("sync")


def host(t):
    """Tensor t's values as a host numpy array: a CUDA tensor waits for
    its stream and copies."""
    if t.device.type == "cpu":
        return t.numpy()
    with _sync():
        return t.cpu().numpy()


def scalar(t):
    """A one-element tensor's value as a Python int (a CUDA tensor waits
    for its stream)."""
    if t.device.type == "cpu":
        return int(t)
    with _sync():
        return int(t)


def wait_stream(t):
    """Block until the current stream of CUDA tensor t's device has run
    everything enqueued on it."""
    with _sync():
        torch.cuda.current_stream(t.device).synchronize()


def merge_rows(rows_list, useds_list):
    """Scatter per-plane blob rows into one flat byte buffer at offsets
    given by the exclusive cumsum of used lengths, plane-major order.
    rows_list[c]: (nfr, cap_c) uint8; useds_list[c]: (nfr,) int32.
    Returns (buf uint8[sum of caps], useds_flat int32)."""
    useds = torch.cat(useds_list)
    if useds.dtype != _I32:
        raise TypeError("useds must be int32")
    offs = torch.cumsum(useds, dim=0, dtype=_I32) - useds
    flatcap = sum(r.shape[0] * r.shape[1] for r in rows_list)
    dev = useds.device
    buf = torch.zeros(flatcap + 1, dtype=torch.uint8, device=dev)  # +sink
    pos = 0
    for rows, used_c in zip(rows_list, useds_list):
        nfr, cap_c = rows.shape
        off_c = offs[pos:pos + nfr]
        col = torch.arange(cap_c, dtype=_I32, device=dev)[None, :]
        idx = torch.where(col < used_c[:, None], off_c[:, None] + col,
                          flatcap)
        buf.scatter_(0, idx.reshape(-1).to(torch.int64), rows.reshape(-1))
        pos += nfr
    return buf[:flatcap], useds


def slice_packed(buf, total_bytes):
    """The occupied prefix of a merged buffer (a view; at least 1 byte).
    The twin buckets the length to keep its jitted slice cached; eager
    torch has nothing to cache."""
    return buf[:max(int(total_bytes), 1)]


def start_d2h(t):
    """Start copying tensor t to the host without blocking: into pinned
    memory with a CUDA event behind it (the counterpart of JAX's
    copy_to_host_async). Returns a handle for finish_d2h."""
    if t.device.type != "cuda":
        return t, None
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return buf, ev


def finish_d2h(handle):
    """Wait for a start_d2h copy; returns the host numpy array."""
    buf, ev = handle
    if ev is not None:
        with _sync():
            ev.synchronize()
    return buf.numpy()


def upload(a, device):
    """numpy array -> tensor on `device`; to CUDA through pinned memory,
    without blocking the host."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
