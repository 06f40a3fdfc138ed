"""torch port: the lossless intra batch encode is exact, and its scan blob
fallback is traced.

`parallel/batch.encode_intra_batch` at `-qp=100 -gop=0` (4:4:4, 64x48 and
the odd 100x62), on seeded inputs: the benchmark's clip, uniform random
noise (every plane leaves the scan blob's contract) and flat 0 and flat
255 frames (the reversible transform's extremes). Each stream is judged
by the benchmark's lossless reference (codecbench/reference/lossless.py,
the frozen conformance decoder): no fault, no sample of any plane other
than its source's. Under tracing the counter `blob.fallback` equals
`enc.stats.blob_fallbacks`, and the spans `batch.fallback.fetch` and
`batch.fallback.code` are there exactly when a plane fell back; at
`-qp=60` the clip stays on the native fast path, which records neither."""
import numpy as np
import pytest
import torch

from torch_parity import REPO  # noqa: F401  (DSV2_TORCH_DEVICE=cpu)
from codecbench import clip, program
from codecbench.reference import lossless
from dsv2_tpu_torch.parallel import batch
from dsv2_tpu_torch.utils import trace

SPANS = ("batch.fallback.fetch", "batch.fallback.code")
SIZES = ((64, 48), (100, 62))
INPUTS = ("clip", "noise", "flat0", "flat255")
NFRAMES, CHUNK = 3, 2      # two chunks: one of 2 frames, one of 1


def frames_of(kind, w, h, seed=2 ** 31 + 21):
    if kind == "clip":
        return clip.make_clip(w, h, NFRAMES, "444", seed)
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return [tuple(rng.integers(0, 256, (h, w), dtype=np.uint8)
                      for _ in range(3)) for _ in range(NFRAMES)]
    value = {"flat0": 0, "flat255": 255}[kind]
    return [tuple(np.full((h, w), value, np.uint8) for _ in range(3))
            for _ in range(NFRAMES)]


def encode_traced(frames, w, h, qp):
    """(stream, enc, counters, span totals) of a traced batch encode."""
    cfg = dict(width=w, height=h, subsamp="444", fps_num=30, fps_den=1,
               qp=qp)
    trace.reset()
    trace.enable(True)
    try:
        enc = program.encoder(cfg, 0, torch.device("cpu"))
        out = batch.encode_intra_batch(enc, frames, chunk=CHUNK)
        out += enc.end_of_stream()
        counts, totals = trace.counters(), trace.totals()
    finally:
        trace.enable(False)
        trace.reset()
    return b"".join(out), enc, cfg, counts, totals


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("w,h", SIZES)
def test_lossless_decodes_to_its_source(kind, w, h):
    frames = frames_of(kind, w, h)
    stream, enc, cfg, counts, totals = encode_traced(frames, w, h, 100)
    faults, differing, mses = lossless.lossless_faults(
        stream, dict(enumerate(frames)), NFRAMES, cfg, 0, True)
    assert (faults, differing) == (0, 0)
    assert mses == [0.0] * NFRAMES
    fell_back = enc.stats.blob_fallbacks
    if kind == "noise":
        assert fell_back == 3 * NFRAMES     # every plane leaves the blob
    assert counts.get("blob.fallback", 0) == fell_back
    for name in SPANS:
        assert (name in totals) == (fell_back > 0), (name, fell_back)


def test_fast_path_records_no_fallback_span():
    w, h = SIZES[0]
    frames = frames_of("clip", w, h)
    stream, enc, cfg, counts, totals = encode_traced(frames, w, h, 60)
    assert enc.stats.blob_fallbacks == 0
    assert "blob.fallback" not in counts
    assert not set(SPANS) & set(totals)
    assert "batch.serialize" in totals
    faults, differing, mses = lossless.lossless_faults(
        stream, dict(enumerate(frames)), NFRAMES, cfg, 0, True)
    # lossy: the reference decodes it whole and finds it other than its
    # source, as the benchmark's control must be
    assert faults == 0 and differing > 0 and max(mses) > 0
