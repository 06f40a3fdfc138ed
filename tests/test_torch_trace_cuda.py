"""torch port on the card: every host-device wait of the benchmark's
jobs goes through the counted wait helper of parallel/xfer.py, and the
trace module's spans and counters never wait for, allocate on or launch
on the card, with tracing on or off.

The jobs are the benchmark's (codecbench/): one CIF lockstep job of 8
lanes x 48 frames, one FHD intra chunk of 16 frames and the first frames
of the single FHD stream (one I and two P frames), each run traced
under torch.cuda.set_sync_debug_mode("warn"); each synchronizing call's
warning is traced back to the innermost frame of the port that made it.

Marked `cuda`; each test skips (from the `cuda` fixture, never at import)
where torch sees no GPU. Run on the card with
`python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda
tests/test_torch_trace_cuda.py`."""
import collections
import os
import traceback
import warnings

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dsv2_tpu_torch") + os.sep
HELPER = os.path.join(PORT, "parallel", "xfer.py")
SEED = 2 ** 31 + 77


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    import sys
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return torch.device("cuda")


def _sync_sites(fn):
    """fn()'s result and {(file, line): n} of the port's frames that made
    a synchronizing CUDA call while it ran: for each warning of
    set_sync_debug_mode("warn"), the innermost frame under
    dsv2_tpu_torch/ (where none is, the innermost frames of the stack,
    and line 0)."""
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f.filename.startswith(PORT)]
        if port:
            sites[(port[-1].filename, port[-1].lineno)] += 1
        else:
            sites[(" <- ".join("%s:%d" % (os.path.basename(f.filename),
                                          f.lineno)
                               for f in reversed(stack[-6:])), 0)] += 1

    torch.cuda.synchronize()
    # the mode is set outside the hook: setting it warns on its own
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sites


def _traced(fn):
    from dsv2_tpu_torch.utils import trace
    trace.reset()
    trace.enable(True)
    try:
        out, sites = _sync_sites(fn)
    finally:
        trace.enable(False)
    return out, sites, trace.counters(), trace.records()


def _check_sites(sites, counters):
    outside = {"%s:%d" % (os.path.relpath(f, REPO) if f.startswith(REPO)
                          else f, ln): n
               for (f, ln), n in sites.items() if f != HELPER}
    assert not outside, "host-device waits outside the helper: %r" % outside
    # each counted wait makes at most one synchronizing call
    assert sum(sites.values()) <= counters.get("sync", 0)


def _bench(name):
    from codecbench import harness
    b = harness.Bench(REPO)
    cell = b.cell(name)
    return b.config(cell["config"]), b.traffic(cell["traffic"])


def test_lockstep_job_waits_only_in_the_helper(cuda):
    from codecbench import program
    cfg, traffic = _bench("cif_lockstep_encode_x8")
    program.prepare(cuda)
    lanes = program.lane_clips(cfg, traffic, SEED)
    want = program.encode_lanes(cfg, traffic, lanes, cuda)   # warm, untraced
    got, sites, counters, recs = _traced(
        lambda: program.encode_lanes(cfg, traffic, lanes, cuda))
    assert got == want
    _check_sites(sites, counters)
    syncs = [r for r in recs if r.name == "sync"]
    assert len(syncs) == counters["sync"] > 0
    flushes = [r for r in recs if r.name == "lockstep.flush"]
    assert len(flushes) == sum(v for k, v in counters.items()
                               if k.startswith("lockstep.flushes."))
    assert counters["launch.vk_chain"] > 0


def test_intra_chunk_waits_only_in_the_helper(cuda):
    from codecbench import clip, program
    from dsv2_tpu_torch.parallel import batch
    cfg, traffic = _bench("fhd_intra_encode")
    program.prepare(cuda)
    frames = clip.make_clip(cfg["width"], cfg["height"], traffic["chunk"],
                            cfg["subsamp"], SEED)

    def job():
        enc = program.encoder(cfg, traffic["gop"], cuda)
        return b"".join(batch.encode_intra_batch(enc, frames,
                                                 chunk=traffic["chunk"]))
    want = job()
    got, sites, counters, _ = _traced(job)
    assert got == want
    _check_sites(sites, counters)
    assert counters["sync"] > 0 and counters["launch.vk_chain"] == 3


def test_live_p_frames_wait_only_in_the_helper(cuda):
    """The single stream of fhd_p_encode (`Encoder.encode_frame`: kernels
    4/5 and the one-frame P chain): no wait hides inside its
    `encode.dispatch.*` spans, so their self time less their `sync`
    children is the host's enqueue. The P chain, a replay of its CUDA
    graph, waits not at all: a P frame's waits are the motion search's
    and its blob's fetch."""
    from codecbench import clip, program
    cfg, traffic = _bench("fhd_p_encode")
    program.prepare(cuda)
    frames = clip.make_clip(cfg["width"], cfg["height"], 3, cfg["subsamp"],
                            SEED)

    def job():
        enc = program.encoder(cfg, traffic["gop"], cuda)
        out = []
        for planes in frames:
            out += enc.encode_frame(planes)
        out += enc.end_of_stream()
        return b"".join(out)
    want = job()   # the P chain's first call, then its graph's capture
    got, sites, counters, recs = _traced(job)
    assert got == want
    _check_sites(sites, counters)
    p_chain = [r for r in recs if r.name == "encode.dispatch.p_chain"]
    assert len(p_chain) == counters["launch.hme_level0"] > 0
    assert counters["graph.replay.p_chain"] == len(p_chain)
    # the P chain is a replay, with no wait inside it; a P frame waits
    # only to read the motion search's fields and to fetch its blob
    by_id = {r.id: r for r in recs}

    def ancestors(r):
        while r.parent in by_id:
            r = by_id[r.parent]
            yield r
    frames = {r.id for r in recs if r.name == "encode_frame"
              and r.ids["fnum"] in {p.ids["fnum"] for p in p_chain}}
    p_waits = 0
    for r in recs:
        if r.name != "sync":
            continue
        up = list(ancestors(r))
        assert "encode.dispatch.p_chain" not in [a.name for a in up]
        if any(a.id in frames for a in up):
            p_waits += 1
            assert {a.name for a in up} & {"encode.fetch",
                                           "encode.motion_est"}, \
                [a.name for a in up]
    assert p_waits > 0


@pytest.mark.parametrize("tracing", [False, True])
def test_spans_and_counters_never_touch_the_card(cuda, tracing):
    """Spans, counters, ids and recorded spans, with tracing on or off and
    under a profiler: no synchronizing call (sync debug mode "error"
    raises on one), no allocation, no kernel or copy on the card."""
    from torch.profiler import ProfilerActivity, profile
    from dsv2_tpu_torch.utils import trace
    x = torch.ones(1024, device=cuda)
    torch.cuda.synchronize()
    trace.reset()
    trace.enable(tracing)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            allocs = torch.cuda.memory_stats(cuda)[
                "allocation.all.allocated"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                trace.set_ids(lane=0)
                for i in range(200):
                    t0 = trace.mark()
                    with trace.stage("outer", fnum=i):
                        trace.count("launch.x")
                        with trace.stage("inner"):
                            trace.tag(flush=i)
                            trace.count("sync", 2)
                    trace.record("gap", t0, flush=i)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            # no allocation on the card: its count of allocations stayed
            assert torch.cuda.memory_stats(cuda)[
                "allocation.all.allocated"] == allocs
        got = trace.counters()
    finally:
        trace.enable(False)
        trace.set_ids()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev == []
    if tracing:
        assert got == {"launch.x": 200, "sync": 400}
        assert sum(e.name == "outer" for e in prof.events()) == 200
    else:
        assert got == {} and trace.records() == []
    trace.reset()
    del x
