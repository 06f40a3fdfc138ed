"""torch port on the card: the hand-written CUDA kernels (the vk chain,
the in-loop filter wavefront, the motion search) against their plain
versions, the motion search's exact square root over every uint32, and
the device encode and decode paths against the golden streams (corrupt
streams and the arena geometries too, and the motion search backends
that alias "pallas").

Marked `cuda`; each test skips (from the `cuda` fixture, never at import)
where torch sees no GPU. Run them on the card with
`python -m pytest -m cuda tests/test_torch_cuda.py`."""
import numpy as np
import pytest
import torch

from torch_parity import tt
import torch_port_golden as golden  # after torch_parity (sys.path)
from dsv2_tpu_torch.cli import read_y4m

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


class _Launches:
    """Kernel launches since the test began: the port's counters
    `launch.<name>` (utils/trace)."""

    def __call__(self, name):
        from dsv2_tpu_torch.utils import trace
        return trace.counters().get("launch." + name, 0)

    def filters(self):
        from dsv2_tpu_torch.ops import filters
        return {k: self("wavefront_filter." + k) for k in filters.KINDS}

    def hme(self):
        return {k: self(k) for k in ("hme_level", "hme_level0",
                                     "hme_gang_level", "hme_gang_level0")}


@pytest.fixture
def launches():
    """Tracing on for the test, so the launch counters count."""
    from dsv2_tpu_torch.utils import trace
    trace.reset()
    trace.enable(True)
    yield _Launches()
    trace.enable(False)
    trace.reset()


@pytest.mark.parametrize("nb", [1, 3, 16, 32, 33, 40, 300])
def test_vk_kernel_vs_plain(cuda, nb, launches):
    """Random chains, every adversarial kind of golden.vk_case, an npad
    that is not a multiple of 4, and 20 launches that must agree."""
    from dsv2_tpu_torch.ops import scan_pl
    rng = np.random.default_rng(nb)
    npad = 8192
    thr = rng.integers(0, 60, (npad, nb)).astype(np.int32)
    thr[rng.random((npad, nb)) < 0.4] = 0
    s0 = rng.integers(0, 3000, nb).astype(np.int32)
    nnz = np.maximum(s0, rng.integers(0, npad + 100, nb)).astype(np.int32)
    cases = [(thr, s0, nnz)] + [golden.vk_case(k, nb, npad)
                                for k in golden.VK_KINDS]
    cases.append(golden.vk_case("random", nb, 4099))
    for thr, s0, nnz in cases:
        args = [tt(a) for a in (thr, s0, nnz)]
        want = scan_pl.vk_chain_plain(*args)
        n0 = launches("vk_chain")
        got = scan_pl.vk_chain(*(a.to(cuda) for a in args))
        torch.cuda.synchronize()
        assert launches("vk_chain") == n0 + -(-nb // 256)
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu(), want)
    args = [tt(a).to(cuda) for a in cases[0]]
    first = scan_pl.vk_chain(*args)
    for _ in range(19):
        assert torch.equal(scan_pl.vk_chain(*args), first)


@pytest.mark.parametrize("plan", [(64, 0, 128), (256, 128, 32),
                                  (1024, 256, 128), (2048, 512, 256)])
def test_vk_kernel_plans(cuda, plan):
    """Chunk lengths, warm-ups and walkers per block other than the
    defaults, raw launches of the three passes: equal to the plain
    version, with the resolve pass's counters consistent."""
    from dsv2_tpu_torch.ops import _kernels, scan_pl
    chunk, warmup, walkers = plan
    for kind in golden.VK_KINDS:
        args = [tt(a) for a in golden.vk_case(kind, 16, 8192, seed=1)]
        want = scan_pl.vk_chain_plain(*args)
        thr, s0, nnz = (a.to(cuda) for a in args)
        out = torch.empty_like(thr)
        scratch = torch.empty(_kernels.vk_scratch_bytes(8192, 16, chunk),
                              dtype=torch.uint8, device=cuda)
        stats = torch.zeros(5, dtype=torch.int32, device=cuda)
        _kernels.vk_chain(thr, s0, nnz, out, scratch, chunk, warmup, walkers,
                          stats=stats)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), kind
        live, met, rewalked, rewalk_met, _ = stats.tolist()
        assert live == met + rewalked and rewalk_met <= rewalked, stats


def test_vk_kernel_cif_chains(cuda):
    """The real CIF luma and chroma chains (8 frames at -qp=60 -gop=0, the
    batched intra step on the card): equal to the plain version, and both
    branches of the resolve pass ran on luma."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.ops import hzcc, scan_pl
    from dsv2_tpu_torch.parallel import batch
    frames, meta = read_y4m(golden.input_path("cif352x288_420_12f"))
    enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=0),
                           device=cuda)
    ctx = batch._prep_chunk(enc, frames[:8])
    p = ctx["p"]
    xs, bds, qs = batch._chunk_inputs(enc, ctx)
    fn = batch._device_batch_fn(meta.width, meta.height, meta.subsamp,
                                p.blk_w, p.blk_h, p.lossless, p.do_psy,
                                ctx["analyze"])
    vs = fn(xs[0], xs[1], xs[2], bds, qs)[2]
    for c in (0, 1, 2):
        args = scan_pl.vk_chain_inputs(tuple(hzcc.scan_segments(
            *ctx["pcfg"].cdims[c])), vs[c])
        stats = torch.zeros(5, dtype=torch.int32, device=cuda)
        got = scan_pl.vk_chain(*args, stats=stats)
        want = scan_pl.vk_chain_plain(*(a.cpu() for a in args))
        assert torch.equal(got.cpu(), want), c
        live, met, rewalked, rewalk_met, _ = stats.tolist()
        assert live == met + rewalked
        if c == 0:
            assert met > rewalked > 0 and rewalk_met > 0, stats


def test_vk_kernel_rejects(cuda):
    from dsv2_tpu_torch.ops import scan_pl
    thr = torch.zeros((64, 2), dtype=torch.int32, device=cuda)
    s0 = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scan_pl.vk_chain(thr.T.contiguous().T, s0, s0)   # not contiguous
    with pytest.raises(ValueError):
        scan_pl.vk_chain(thr, s0.cpu(), s0)


def test_scan_blob_cuda_vs_cpu(cuda):
    from dsv2_tpu_torch.ops import hzcc, scan_pl
    segs = tuple(hzcc.scan_segments(352, 288))
    total = sum(c for c, _ in segs)
    rng = np.random.default_rng(5)
    v = (rng.integers(-127, 128, (3, total))
         * (rng.random((3, total)) < 0.15)).astype(np.int32)
    v[:, :segs[0][0]] = rng.integers(-9000, 9000, (3, segs[0][0]))
    fn = scan_pl.make_scan_blob(segs, total)
    want = fn(tt(v))
    got = fn(tt(v).to(cuda))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("plane", [0, 1])
def test_scan_blob_fhd_chunk_cuda_vs_cpu(cuda, plane):
    """make_scan_blob at the FHD intra batch's shape: a 16-frame chunk of
    a 1920x1080 4:2:0 luma or chroma plane at the path's cap, seeded
    planes as sparse as -qp=60's (3-15% nonzero), one with no run and one
    dense (over the cap: a fallback). Blob, nbytes and fallback on the
    card equal the CPU's."""
    from dsv2_tpu_torch.codec.devsteps import blob_cap
    from dsv2_tpu_torch.core import constants as K
    from dsv2_tpu_torch.core.frame import coef_dims
    from dsv2_tpu_torch.ops import hzcc, scan_pl
    cw, ch = coef_dims(K.SUBSAMP_420, 1920, 1080)[plane]
    segs = tuple(hzcc.scan_segments(cw, ch))
    total, ll_n = sum(c for c, _ in segs), segs[0][0]
    rng = np.random.default_rng(60 + plane)
    v = np.round(rng.laplace(0, 6, (16, total))).clip(-127, 127)
    v[:, :ll_n] = np.round(rng.laplace(0, 900, (16, ll_n)))
    density = np.array([0.0, 1.0] + [0.03, 0.05, 0.1, 0.15] * 3 + [0.05,
                                                                    0.05])
    v[rng.random((16, total)) >= density[:, None]] = 0
    v = v.astype(np.int32)
    fn = scan_pl.make_scan_blob(segs, blob_cap(total))
    want = fn(tt(v))
    got = fn(tt(v).to(cuda))
    assert want[2].tolist() == [False, True] + [False] * 14
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", ["tiny64x48_420_6f", "odd100x62_420_4f",
                                  "cif352x288_420_12f"])
def test_batch_golden_cuda(cuda, name):
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames, meta, 60, batch=encode_intra_batch,
                         chunk=4, device=cuda)
    want = golden.load()[golden.key(name, 60)]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    seq = golden.encode(cli, frames, meta, 60, device=cuda)
    assert seq == data


def _filter_inputs(kind, w, h, blk, nb, seed):
    """Public-API arguments of one batched filter call (CPU tensors)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype)
    nbh, nbv = -(-w // blk), -(-h // blk)
    if kind == "chroma":
        w, h, blk = w // 2, h // 2, blk // 2
    # gradients with mild noise and steps at 8x8 cells: tile energies in
    # every filter's working range; the bottom third is pure noise
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    cells = rnd(-24, 25, (nb, -(-h // 8), -(-w // 8)))
    steps = cells.repeat_interleave(8, 1).repeat_interleave(8, 2)
    vis = (xx // 3 + yy // 2 + 64 + steps[:, :h, :w]
           + rnd(-3, 4, (nb, h, w))).clamp(0, 255).to(torch.uint8)
    vis[:, 2 * h // 3:] = rnd(0, 256, (nb, h - 2 * h // 3, w), torch.uint8)
    mv = (rnd(-40, 41, (nb, nbv, nbh)), rnd(-40, 41, (nb, nbv, nbh)),
          rnd(0, 256, (nb, nbv, nbh)), rnd(0, 16, (nb, nbv, nbh)))
    fq = rnd(600, 1600, (nb,))
    if kind == "intra":
        return (w, h, nbh, nbv, vis, rnd(0, 64, (nb, nbv, nbh), torch.uint8),
                fq, rnd(100, 200, (nb,)))
    if kind == "luma":
        return (w, h, nbh, nbv, blk, blk, 1, vis) + mv + (
            fq, rnd(100, 200, (nb,)), 1, rnd(0, 2, (nb,)))
    return (w, h, nbh, nbv, blk, blk, vis) + mv[:3] + (rnd(100, 3000,
                                                           (nb,)),)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("kind", ["intra", "luma", "chroma"])
@pytest.mark.parametrize("w,h,blk", [(352, 288, 16), (640, 360, 32),
                                     (100, 62, 16), (64, 500, 32),
                                     (352, 16, 16)])
def test_filter_kernel_vs_plain(cuda, kind, nb, w, h, blk, launches):
    from dsv2_tpu_torch.ops import filters
    fn = getattr(filters, kind + "_filter_graph")
    args = _filter_inputs(kind, w, h, blk, nb, w + nb)
    want = fn(*args)
    n0 = launches("wavefront_filter." + kind)
    got = fn(*(a.to(cuda) if isinstance(a, torch.Tensor) else a
               for a in args))
    torch.cuda.synchronize()
    assert launches("wavefront_filter." + kind) == n0 + 1
    assert got.dtype == torch.uint8 and got.is_cuda
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, args[4 if kind == "intra" else
                                      (7 if kind == "luma" else 6)])


# layouts the codec makes that one CTA's shared memory cannot hold whole
# (4:4:4 chroma at 1440p and 4K runs on a cluster) and 4K luma/intra, held
# against the port's native C filters (raster order, on the host)
LARGE = [("intra", 3840, 2160, 32, (1, 1), 1), ("luma", 3840, 2160, 32,
                                                (1, 1), 1),
         ("chroma", 2560, 1440, 32, (0, 0), 2),
         ("chroma", 3840, 2160, 32, (0, 0), 4)]


@pytest.mark.parametrize("kind,w,h,blk,shifts,clusters", LARGE,
                         ids=["%s-%dx%d" % c[:3] for c in LARGE])
def test_filter_kernel_large_vs_native(cuda, kind, w, h, blk, shifts,
                                       clusters, launches):
    from dsv2_tpu_torch.ops import _kernels, filters
    args = golden.filter_case(kind, w, h, blk, shifts, seed=w, nb=1)
    want = golden.filter_native(kind, args)
    plans = []
    wf = filters.wavefront_filter

    def rec(kind_, lay, plane, props, scal):
        plans.append(filters.wavefront_plan(
            lay, max_smem=_kernels.max_smem()))
        return wf(kind_, lay, plane, props, scal)
    n0 = launches("wavefront_filter." + kind)
    filters.wavefront_filter = rec
    try:
        got = getattr(filters, kind + "_filter_graph")(
            *(a.to(cuda) if isinstance(a, torch.Tensor) else a
              for a in args))
        torch.cuda.synchronize()
    finally:
        filters.wavefront_filter = wf
    assert launches("wavefront_filter." + kind) == n0 + 1
    assert [p.C for p in plans] == [clusters]
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, args[{"intra": 4, "luma": 7}.get(kind, 6)])


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["intra", "luma", "chroma"])
def test_filter_kernel_clusters(cuda, kind, cluster):
    """Each cluster size on a layout that fits one CTA: equal to the
    native filters."""
    from dsv2_tpu_torch.ops import _kernels, filters
    args = golden.filter_case(kind, 640, 360, 16, seed=cluster, nb=2)
    want = golden.filter_native(kind, args)
    wf = filters.wavefront_filter
    plans = []

    def forced(kind_, lay, plane, props, scal):
        plans.append(_kernels.wavefront_filter(
            filters.KINDS.index(kind_), lay, plane, props, scal,
            cluster=cluster))
        return plane
    filters.wavefront_filter = forced
    try:
        got = getattr(filters, kind + "_filter_graph")(
            *(a.to(cuda) if isinstance(a, torch.Tensor) else a
              for a in args))
        torch.cuda.synchronize()
    finally:
        filters.wavefront_filter = wf
    assert [p.C for p in plans] == [cluster]
    assert torch.equal(got.cpu(), want)


# (kind, w, h, blk, chroma shifts, forced): 16x16384 4:4:4 chroma in 32x32
# blocks (no cluster holds it: the plan takes the global ring), and small
# layouts of every kind forced onto it
GLOBAL = [("chroma", 16, 16384, 32, (0, 0), False),
          ("intra", 640, 360, 16, (1, 1), True),
          ("luma", 640, 360, 16, (1, 1), True),
          ("chroma", 640, 360, 16, (1, 1), True)]


@pytest.mark.parametrize("kind,w,h,blk,shifts,forced", GLOBAL,
                         ids=["%s-%dx%d" % c[:3] for c in GLOBAL])
def test_filter_kernel_global_ring(cuda, kind, w, h, blk, shifts, forced):
    """The ring rows in a global scratch, one CTA: equal to the native
    filters, 2 planes in one launch."""
    from dsv2_tpu_torch.ops import _kernels, filters
    args = golden.filter_case(kind, w, h, blk, shifts, seed=h, nb=2)
    want = golden.filter_native(kind, args)
    wf = filters.wavefront_filter
    plans = []

    def run(kind_, lay, plane, props, scal):
        plans.append(_kernels.wavefront_filter(
            filters.KINDS.index(kind_), lay, plane, props, scal,
            ring="global" if forced else None))
        return plane
    filters.wavefront_filter = run
    try:
        got = getattr(filters, kind + "_filter_graph")(
            *(a.to(cuda) if isinstance(a, torch.Tensor) else a
              for a in args))
        torch.cuda.synchronize()
    finally:
        filters.wavefront_filter = wf
    assert [(p.ring, p.C) for p in plans] == [("global", 1)]
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, args[{"intra": 4, "luma": 7}.get(kind, 6)])


def test_filter_kernel_rejects(cuda, launches):
    """Malformed inputs raise before any launch."""
    from dsv2_tpu_torch.ops import filters
    lay = filters._layout(64, 48, 4, 4, 15, 11)
    plane = torch.zeros((1, lay.HP, lay.WP), dtype=torch.int32, device=cuda)
    props = torch.zeros((1, 1, 11, 15), dtype=torch.int32, device=cuda)
    scal = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    n0 = launches.filters()
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane, props.cpu(), scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane.transpose(1, 2)
                                 .contiguous().transpose(1, 2), props, scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane.long(), props, scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("luma", lay, plane, props, scal)
    with pytest.raises(ValueError, match="malformed"):   # 6-pixel tiles
        bad = lay._replace(tw=6, ww=14)
        filters.wavefront_filter("intra", bad, plane, props, scal)
    assert launches.filters() == n0


@pytest.mark.parametrize("key", ["tiny64x48_422_4f@qp60_gop4",
                                 "cif352x288_420_12f@qp60_gop12"])
def test_decode_p_golden_cuda(cuda, key, launches):
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    data = golden.read_stream(key)
    n0 = launches.filters()
    y = golden.decoded_y4m(decoder, y4m, data,
                           decoder=decoder.Decoder(device=cuda))
    want = golden.load()[key]["decode"]
    assert golden.digest(y) == want
    n = {k: launches("wavefront_filter." + k) - n0[k]
         for k in ("luma", "chroma")}
    assert n["luma"] > 0 and n["chroma"] == n["luma"]   # U+V: one launch


@pytest.mark.parametrize("key", ["cif352x288_420_12f@crf_gop6",
                                 "cif352x288_420_12f@qp85"])
def test_decode_dense_golden_cuda(cuda, key):
    """Streams with pictures the compact scan upload cannot carry decode
    on the card's device chain (dense upload) to dsv2_tpu's y4m."""
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    y = golden.decoded_y4m(decoder, y4m, golden.read_stream(key),
                           decoder=decoder.Decoder(device=cuda))
    assert golden.digest(y) == golden.load()[key]["decode"]


def test_decode_intra_golden_cuda(cuda):
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.parallel.batch import encode_intra_batch
    from dsv2_tpu_torch.utils import y4m
    name = "cif352x288_420_12f"
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames, meta, 60, batch=encode_intra_batch,
                         chunk=4, device=cuda)
    y = golden.decoded_y4m(decoder, y4m, data,
                           decoder=decoder.Decoder(device=cuda))
    assert golden.digest(y) == golden.load()[golden.key(name, 60)]["decode"]


@pytest.mark.parametrize("name,has_tmv,effort", [
    ("nano48x32_420_4f", False, 10), ("nano48x32_420_4f", True, 10),
    ("nano48x32_420_4f", True, 5), ("odd100x62_420_4f", True, 10),
    ("tiny64x48_422_4f", True, 10), ("cif352x288_420_12f", False, 10),
    ("cif352x288_420_12f", True, 10)])
def test_hme_kernels_vs_plain(cuda, name, has_tmv, effort, launches):
    """Both motion-search kernels against the plain version on every field
    and sum (exact), with and without temporal candidates."""
    from dsv2_tpu_torch.ops import hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path(name))
    cfg, inputs = golden.hme_case(frames, meta, has_tmv=has_tmv,
                                  effort=effort, device=cuda)
    wcfg = hme_wave.WaveCfg(**cfg)
    fn = hme_gpu.make_motion_est(wcfg)
    n0 = launches.hme()
    got = fn(*inputs)
    torch.cuda.synchronize()
    assert launches("hme_level") == (n0["hme_level"]
                                             + wcfg.pyramid_levels)
    assert launches("hme_level0") == n0["hme_level0"] + 1

    def cpu(x):
        if isinstance(x, tuple):
            return tuple(cpu(a) for a in x)
        return x.cpu() if isinstance(x, torch.Tensor) else x
    want = fn(*cpu(inputs))
    for k in golden.HME_OUTPUTS:
        assert got[k].is_cuda and got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k]), k


# (input, has_tmv, effort, hme_case keywords): every effort the subpel and
# chroma tests branch on, with and without temporal candidates; lossless
# 4:4:4; 32x32 blocks; the three extreme geometries of test_edge_dims.py
LEVEL0_CASES = ([("odd100x62_420_4f", tmv, e, {}) for e in (0, 4, 5, 8, 10)
                 for tmv in (False, True)]
                + [("tiny64x48_444_4f", True, 10, dict(lossless=True,
                                                       quant=1)),
                   ("cif352x288_420_12f", True, 10, dict(blk=32)),
                   ("synth352x16_420", True, 10, {}),
                   ("synth16x240_420", True, 10, {}),
                   ("synth64x500_411", True, 10, {})]
                # the block sizes -bszx=0 -bszy=0 and -bszx=1 -bszy=0 force
                + [("tiny64x48_420_6f", tmv, 10, dict(blk=blk))
                   for blk in (16, (32, 16)) for tmv in (False, True)])


@pytest.mark.parametrize("name,has_tmv,effort,kw", LEVEL0_CASES,
                         ids=["%s-tmv%d-e%d%s" % (c[0], c[1], c[2], "".join(
                             "-%s%s" % kv for kv in c[3].items()))
                             for c in LEVEL0_CASES])
def test_hme_level0_cases(cuda, name, has_tmv, effort, kw):
    """Kernels 4/5 (the base level on the dataflow scheduler) against the
    plain version on every field and sum (exact)."""
    from dsv2_tpu_torch.ops import hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path(name))
    cfg, inputs = golden.hme_case(frames, meta, has_tmv=has_tmv,
                                  effort=effort, device=cuda, **kw)
    fn = hme_gpu.make_motion_est(hme_wave.WaveCfg(**cfg))
    got = fn(*inputs)
    want = fn(*_cpu(inputs))
    for k in golden.HME_OUTPUTS:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_hme_repeats(cuda):
    """20 searches with kernels 4/5 (CIF) and with kernels 6/7 (8 CIF
    lanes) on the same inputs give identical outputs: workers claim blocks
    in another order each run, so a race would show."""
    from dsv2_tpu_torch.ops import hme_gang, hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path("cif352x288_420_12f"))
    cfg, inputs = golden.hme_case(frames, meta, has_tmv=True, device=cuda)
    cfg8, lanes = golden.hme_lanes(frames, meta, 8, has_tmv=True,
                                   device=cuda)
    for fn in (lambda: hme_gpu.make_motion_est(hme_wave.WaveCfg(**cfg))(
            *inputs), lambda: hme_gang.make_motion_est(
                hme_wave.WaveCfg(**cfg8))(lanes)):
        first = {k: v.clone() for k, v in fn().items()}
        for _ in range(19):
            got = fn()
            for k, v in first.items():
                assert torch.equal(got[k], v), k


def _upper_levels(cfg, lanes, dev):
    """Per upper level, top down: (level, parent, gxy, want) of every
    lane, the plain version's fields fed the plain version's parents (on
    the CPU); parent and gxy on `dev`."""
    from dsv2_tpu_torch.ops import hme_wave
    n = len(lanes)
    lanes = [_cpu(ln) for ln in lanes]
    parent = torch.zeros((n, 2, cfg.nbv, cfg.nbh), dtype=torch.int32)
    gxy = torch.zeros((n, 2), dtype=torch.int32)
    out = []
    for level in range(cfg.pyramid_levels, 0, -1):
        want = torch.stack([torch.stack(hme_wave.refine_level_graph(
            cfg, level, ln[0][level], ln[1][level], ln[2][level],
            parent[i, 0], parent[i, 1], ln[7], ln[8], gxy[i, 0], gxy[i, 1],
            int(ln[9]))) for i, ln in enumerate(lanes)])
        out.append((level, parent.to(dev), gxy.to(dev), want))
        parent = want
        gxy = torch.stack([torch.stack(hme_wave.global_motion_graph(
            cfg, level, w[0], w[1])) for w in want])
    return out


UPPER_WORKERS = [1, 2, 3, 7, 64, 0]


@pytest.mark.parametrize("name,has_tmv", [("cif352x288_420_12f", True),
                                          ("odd100x62_420_4f", False)])
def test_hme_upper_workers(cuda, name, has_tmv):
    """Kernel 4 (an upper level on the dataflow scheduler) at every upper
    level and 1 to 64 workers (0: the default; through the C entry)
    against the plain version, fed the same parent field; 20 launches of
    each level through hme_gpu.hme_level identical."""
    from dsv2_tpu_torch.ops import _kernels, hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path(name))
    cfgd, inputs = golden.hme_case(frames, meta, has_tmv=has_tmv,
                                   device=cuda)
    cfg = hme_wave.WaveCfg(**cfgd)
    sp, rp, op, _, _, _, _, tmx, tmy, quant, _ = inputs
    tmv = torch.stack([tmx, tmy]).contiguous()
    for level, parent, gxy, want in _upper_levels(cfg, [inputs], cuda):
        geom = hme_gpu.geometry(cfg, level, [sp[level]], [], int(quant), 0)
        for w in UPPER_WORKERS:
            out = torch.zeros((2, cfg.nbv, cfg.nbh), dtype=torch.int32,
                              device=cuda)
            _kernels.hme_level(sp[level], rp[level], op[level], parent[0],
                               tmv, gxy[0], out,
                               hme_gpu._sched(cfg, 1, cuda, level), geom, w)
            assert torch.equal(out.cpu(), want[0]), (level, w)

        def run():
            return hme_gpu.hme_level(cfg, level, sp[level], rp[level],
                                     op[level], parent[0], tmv, gxy[0],
                                     int(quant))
        first = run()
        assert torch.equal(first.cpu(), want[0]), level
        for _ in range(19):
            assert torch.equal(run(), first), level


@pytest.mark.parametrize("gang", [1, 2, 4])
def test_hme_gang_upper_workers(cuda, gang):
    """Kernel 6 on 8 CIF lanes (every lane's blocks on one scheduler) at
    every upper level, G = 1, 2, 4 and 1 to 64 workers, against the plain
    version lane by lane; 20 launches of each level identical."""
    from dsv2_tpu_torch.ops import _kernels, hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path("cif352x288_420_12f"))
    cfgd, lanes = golden.hme_lanes(frames, meta, 8, has_tmv=True,
                                   device=cuda)
    cfg = hme_wave.WaveCfg(**cfgd)
    tmv = torch.stack([torch.stack([ln[7], ln[8]]) for ln in lanes]
                      ).contiguous()
    quants = [int(ln[9]) for ln in lanes]
    for level, parent, gxy, want in _upper_levels(cfg, lanes, cuda):
        planes = [[ln[k][level] for ln in lanes] for k in range(3)]
        for w in UPPER_WORKERS:
            out = torch.zeros((len(lanes), 2, cfg.nbv, cfg.nbh),
                              dtype=torch.int32, device=cuda)
            geom, ptrs, scal = hme_gpu._gang_args(
                cfg, level, [([s, r, o], []) for s, r, o in zip(*planes)],
                parent, tmv, gxy, out, None, quants, [0] * len(lanes), gang)
            _kernels.hme_gang(False, 32 // gang, geom, ptrs, scal, cuda,
                              hme_gpu._sched(cfg, len(lanes), cuda, level), w)
            assert torch.equal(out.cpu(), want), (level, w)

        def run():
            return hme_gpu.hme_gang_level(cfg, level, *planes, parent, tmv,
                                          gxy, quants, gang=gang)
        first = run()
        assert torch.equal(first.cpu(), want), level
        for _ in range(19):
            assert torch.equal(run(), first), level


def test_isqrt_exhaustive(cuda):
    """The kernels' integer square root (float root + integer correction)
    is floor(sqrt(n)) for all 2^32 uint32 n."""
    from dsv2_tpu_torch.ops import _kernels
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    _kernels.isqrt_check(bad)
    torch.cuda.synchronize()
    assert int(bad) == 0


def test_hme_kernel_rejects(cuda):
    from dsv2_tpu_torch.ops import hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    cfg, inputs = golden.hme_case(frames, meta, device=cuda)
    wcfg = hme_wave.WaveCfg(**cfg)
    lv = wcfg.pyramid_levels
    z = torch.zeros((2, wcfg.nbv, wcfg.nbh), dtype=torch.int32, device=cuda)
    gxy = torch.zeros(2, dtype=torch.int32, device=cuda)
    src, ref, ogr = (x[lv] for x in inputs[:3])
    with pytest.raises(ValueError):
        hme_gpu.hme_level(wcfg, lv, src, ref, ogr.cpu(), z, z, gxy, 1200)
    with pytest.raises(ValueError):
        hme_gpu.hme_level(wcfg, lv, src, ref, ogr, z[:, :1], z, gxy, 1200)


@pytest.mark.parametrize("key", ["tiny64x48_422_4f@qp60_gop4",
                                 "cif352x288_420_12f@qp60_gop12"])
def test_p_encode_golden_cuda(cuda, key, launches):
    from dsv2_tpu_torch import cli
    name, qp, gop, nfr = next(c for c in golden.P_CASES
                              if golden.p_key(c) == key)
    frames, meta = read_y4m(golden.input_path(name))
    n0 = launches("hme_level0")
    data = golden.encode(cli, frames[:nfr], meta, qp, gop=gop, device=cuda)
    want = golden.load()[key]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    assert launches("hme_level0") > n0


@pytest.mark.parametrize("trial", range(8))
def test_decode_corrupt_cuda(cuda, trial, launches):
    """The corrupt CIF trials on the card: the device chain, its filter
    kernel included, gives dsv2_tpu's frames (the twin's host chain)."""
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    want = golden.load()[golden.corrupt_key(trial)]
    dec = decoder.Decoder(device=cuda)
    n0 = sum(launches.filters().values())
    got = golden.decode_frames(decoder, y4m,
                               golden.corrupt_streams()[trial], decoder=dec)
    assert got["frames"] == want["frames"] and got["error"] is None
    assert got["decode"] == want["decode"]
    assert sum(launches.filters().values()) > n0


@pytest.mark.parametrize("name,qp,gop", golden.ARENA_CASES)
def test_arena_golden_cuda(cuda, name, qp, gop, launches):
    """The degenerate geometries: encoded on the card to dsv2_tpu's
    stream, decoded on the card with the arena and the filter kernel to
    its y4m."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.utils import y4m
    want = golden.load()[golden.key(name, qp, gop)]
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames, meta, qp, gop=gop, device=cuda)
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    dec = decoder.Decoder(device=cuda)
    n0 = sum(launches.filters().values())
    y = golden.decoded_y4m(decoder, y4m, data, decoder=dec)
    assert golden.digest(y) == want["decode"] and dec._arena.is_cuda
    assert sum(launches.filters().values()) > n0


@pytest.mark.parametrize("backend", ["host", "wave"])
def test_host_hme_golden_cuda(cuda, backend, launches):
    """CIF -gop=6 with the backends "host" and "wave", aliases of
    "pallas" (kernels 4/5): both dsv2_tpu's "host" stream."""
    from dsv2_tpu_torch import cli
    name, qp, gop, nfr, _ = golden.HOST_HME
    frames, meta = read_y4m(golden.input_path(name))
    n0 = launches("hme_level0")
    data = golden.encode(cli, frames[:nfr], meta, qp, gop=gop, device=cuda,
                         backend=backend)
    want = golden.load()[golden.key(name, qp, gop)]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    assert launches("hme_level0") > n0


def _cpu(x):
    if isinstance(x, tuple):
        return tuple(_cpu(a) for a in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


GANG_GEOMS = ["nano48x32_420_4f", "odd100x62_420_4f", "tiny64x48_422_4f",
              "cif352x288_420_12f"]


@pytest.mark.parametrize("name", GANG_GEOMS)
@pytest.mark.parametrize("has_tmv", [False, True])
def test_hme_gang_vs_plain(cuda, name, has_tmv, launches):
    """The gang kernels (6/7) for 2 lanes against the plain version lane by
    lane on every field and sum (exact): one launch per level."""
    from dsv2_tpu_torch.ops import hme_gang, hme_wave
    frames, meta = read_y4m(golden.input_path(name))
    cfg, lanes = golden.hme_lanes(frames, meta, 2, has_tmv=has_tmv,
                                  device=cuda)
    wcfg = hme_wave.WaveCfg(**cfg)
    n0 = launches.hme()
    got = hme_gang.make_motion_est(wcfg)(lanes)
    torch.cuda.synchronize()
    assert launches("hme_gang_level") == (n0["hme_gang_level"]
                                                  + wcfg.pyramid_levels)
    assert launches("hme_gang_level0") == n0["hme_gang_level0"] + 1
    for i, inputs in enumerate(lanes):
        want = hme_wave.make_motion_est(wcfg)(*_cpu(inputs))
        for k in golden.HME_OUTPUTS:
            assert got[k].is_cuda and got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k][i].cpu(), want[k]), (i, k)


# (input, effort, hme_case keywords) of the gang kernels' modes: the
# efforts below 4 (no subpel) and below 6/8 (no chroma intra test,
# half-pel only), lossless 4:4:4
GANG_MODES = [("odd100x62_420_4f", 0, {}), ("odd100x62_420_4f", 3, {}),
              ("tiny64x48_444_4f", 10, dict(lossless=True, quant=1))]


@pytest.mark.parametrize("name,effort,kw", GANG_MODES,
                         ids=["%s-e%d%s" % (c[0], c[1], "-lossless" * bool(
                             c[2])) for c in GANG_MODES])
@pytest.mark.parametrize("has_tmv", [False, True])
def test_hme_gang_modes_vs_plain(cuda, name, effort, kw, has_tmv):
    """The gang kernels (6/7) for 2 lanes at efforts 0 and 3 and lossless
    against the plain version lane by lane on every field (exact)."""
    from dsv2_tpu_torch.ops import hme_gang, hme_wave
    frames, meta = read_y4m(golden.input_path(name))
    cfg, lanes = golden.hme_lanes(frames, meta, 2, has_tmv=has_tmv,
                                  effort=effort, device=cuda, **kw)
    wcfg = hme_wave.WaveCfg(**cfg)
    got = hme_gang.make_motion_est(wcfg)(lanes)
    for i, inputs in enumerate(lanes):
        want = hme_wave.make_motion_est(wcfg)(*_cpu(inputs))
        for k in golden.HME_OUTPUTS:
            assert torch.equal(got[k][i].cpu(), want[k]), (i, k)


@pytest.mark.parametrize("name", GANG_GEOMS)
@pytest.mark.parametrize("nlanes", [1, 3, 8])
@pytest.mark.parametrize("gang", [1, 2, 4])
def test_hme_gang_vs_pallas(cuda, name, nlanes, gang):
    """1 to 8 lanes, 1, 2 or 4 blocks per warp, with and without temporal
    candidates: every lane equals kernels 4/5 on its own inputs."""
    from dsv2_tpu_torch.ops import hme_gang, hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path(name))
    for has_tmv in (False, True):
        cfg, lanes = golden.hme_lanes(frames, meta, nlanes, has_tmv=has_tmv,
                                      device=cuda)
        wcfg = hme_wave.WaveCfg(**cfg)
        got = hme_gang.make_motion_est(wcfg, gang=gang)(lanes)
        for i, inputs in enumerate(lanes):
            want = hme_gpu.make_motion_est(wcfg)(*inputs)
            for k in golden.HME_OUTPUTS:
                assert torch.equal(got[k][i], want[k]), (has_tmv, i, k)


@pytest.mark.parametrize("nlanes", [1, 7, 8, 32, 33])
def test_hme_gang_lanes(cuda, nlanes, launches):
    """Kernel 7 (every lane's base level on one scheduler; 33 lanes are two
    launches) with 1 to 33 lanes: every lane equals kernels 4/5 on its own
    inputs, and the first lane the plain version."""
    from dsv2_tpu_torch.ops import hme_gang, hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path("odd100x62_420_4f"))
    cfg, lanes = golden.hme_lanes(frames, meta, nlanes, has_tmv=True,
                                  device=cuda)
    wcfg = hme_wave.WaveCfg(**cfg)
    n0 = launches("hme_gang_level0")
    got = hme_gang.make_motion_est(wcfg)(lanes)
    assert launches("hme_gang_level0") - n0 == -(-nlanes // 32)
    plain = hme_wave.make_motion_est(wcfg)(*_cpu(lanes[0]))
    for i, inputs in enumerate(lanes):
        want = hme_gpu.make_motion_est(wcfg)(*inputs)
        for k in golden.HME_OUTPUTS:
            assert torch.equal(got[k][i], want[k]), (i, k)
            if i == 0:
                assert torch.equal(got[k][0].cpu(), plain[k]), k


def test_hme_gang_rejects(cuda):
    from dsv2_tpu_torch.ops import hme_gpu, hme_wave
    frames, meta = read_y4m(golden.input_path("nano48x32_420_4f"))
    cfg, lanes = golden.hme_lanes(frames, meta, 2, device=cuda)
    wcfg = hme_wave.WaveCfg(**cfg)
    lv = wcfg.pyramid_levels
    z = torch.zeros((2, 2, wcfg.nbv, wcfg.nbh), dtype=torch.int32,
                    device=cuda)
    gxy = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    srcs, refs, ogrs = ([ln[k][lv] for ln in lanes] for k in range(3))
    with pytest.raises(ValueError):     # a lane's plane on the CPU
        hme_gpu.hme_gang_level(wcfg, lv, srcs, refs, [ogrs[0], ogrs[1].cpu()],
                               z, z, gxy, [900, 900])
    with pytest.raises(ValueError):     # grids of the wrong lane count
        hme_gpu.hme_gang_level(wcfg, lv, srcs, refs, ogrs, z[:1], z, gxy,
                               [900, 900])
    with pytest.raises(ValueError):     # no such gang width
        hme_gpu.hme_gang_level(wcfg, lv, srcs, refs, ogrs, z, z, gxy,
                               [900, 900], gang=3)


@pytest.mark.parametrize("backend", ["gang", "pallas"])
def test_lockstep_golden_cuda(cuda, backend, launches):
    """3 lockstep streams of tiny64x48_420_6f at -gop=2 on the card equal
    the port's sequential encode of each (tests/test_torch_lockstep.py
    holds that one to dsv2_tpu's)."""
    from dsv2_tpu_torch import cli
    from dsv2_tpu_torch.parallel import dynbatch
    frames, meta = read_y4m(golden.input_path("tiny64x48_420_6f"))
    streams = [frames[0:2], frames[2:4], frames[4:6]]
    want = [golden.encode(cli, s, meta, 60, gop=2, eos=False, device=cuda)
            for s in streams]

    def factory():
        enc = cli.make_encoder(meta, cli.default_enc_opts(qp=60, gop=2),
                               device=cuda)
        enc.hme_backend = backend
        return enc
    n0 = launches.hme()
    got = dynbatch.encode_streams_lockstep(streams, factory, width=4)
    assert got == want
    key = "hme_gang_level0" if backend == "gang" else "hme_level0"
    assert launches(key) > n0[key]


@pytest.mark.parametrize("walkers", [0, 1])
@pytest.mark.parametrize("nb", [16, 701, 704])
def test_probe_gang_vs_plain(cuda, nb, walkers):
    """Every probe kernel (kernel 8) against its plain version, exact, on
    the whole card (a warp per block or gang) and as one walker; 701
    leaves a gang tail of 5 slots that stay 0."""
    from dsv2_tpu_torch.tools import probe_gang as pg
    plane, cx, cy = pg.inputs(nb, device=cuda)
    for mode in pg.MODES:
        for probe, plain in ((pg.block, pg.block_plain),
                             (pg.gang, pg.gang_plain)):
            got = probe(mode, plane, cx, cy, walkers=walkers)
            assert got.is_cuda
            want = plain(mode, *(t.cpu() for t in (plane, cx, cy)))
            assert torch.equal(got.cpu(), want), (probe.__name__, mode)
    assert torch.equal(pg.scalar(plane).cpu(), pg.scalar_plain(plane.cpu()))


def _to(x, dev):
    """Tensors (in lists and tuples too) moved to dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


@pytest.mark.parametrize("step", ["i_chain", "p_chain", "id_chain",
                                  "pd_chain"])
def test_chain_lanes_cuda(cuda, step, launches):
    """The lane-batched chain steps of a lockstep flush at the lockstep
    cell's shapes: 8 CIF lanes, each with its own q, filter scalars,
    motion field and reference, so kernel 1 runs B = 8 chains per plane
    and kernel 2 8 luma (or intra) planes and 16 U+V planes with 8 q's.
    The card's output equals the plain versions' (the same builder on the
    CPU) bit for bit, each lane's fetch included, with one vk launch per
    plane and one filter launch per kind for the flush."""
    import test_torch_lockstep_batch as lb
    from dsv2_tpu_torch.codec import devsteps
    from dsv2_tpu_torch.core import constants as K
    w, h, subsamp = lb.CIF
    n = 8
    decode = step in ("id_chain", "pd_chain")
    if decode:
        isP = step == "pd_chain"
        lanes = lb.decode_lanes("cif", isP, False, (), False, 5, n)[0]
        base = (w, h, subsamp, lb.BLK, lb.BLK, False) + ((1,) if isP
                                                         else ())
        make = (devsteps.make_pd_chain_step if isP
                else devsteps.make_id_chain_step)
        cpu_cfg = base + (False, (), False, "cpu")
        dev_cfg = base + (False, (), False, cuda)
        dev_lanes = [a[:4] + (_to(a[4], cuda),) + a[5:] if isP else a
                     for a in lanes]
        kinds = {"luma": 1, "chroma": 1} if isP else {"intra": 1}
    else:
        isP = step == "p_chain"
        lanes = (lb.p_lanes if isP else lb.i_lanes)("cif", 6, n)
        cpu_cfg = dev_cfg = ((w, h, subsamp, lb.BLK, lb.BLK, False,
                              K.PSY_ALL, lb.LEVELS) + ((1,) if isP else ()))
        make = (devsteps.make_p_chain_step if isP
                else devsteps.make_i_chain_step)
        dev_lanes = _to(lanes, cuda)
        kinds = {"luma": 1, "chroma": 1} if isP else {"intra": 1}
    want = devsteps.lanewise(make)(cpu_cfg)(lanes)
    vk0 = launches("vk_chain")
    wf0 = launches.filters()
    got = devsteps.lanewise(make)(dev_cfg)(dev_lanes)
    torch.cuda.synchronize()
    assert launches("vk_chain") - vk0 == (0 if decode else 3)
    assert {k: v - wf0[k] for k, v in launches.filters().items()
            if v != wf0[k]} == kinds
    for i in range(n):
        if decode:
            assert got[i][0].is_cuda
            assert torch.equal(got[i][0].cpu(), want[i][0])
            for g, wv in zip(got[i][1]["recon"], want[i][1]["recon"]):
                assert torch.equal(g.cpu(), wv)
        else:
            lb._check_lane_out(got[i], want[i], i)


@pytest.mark.parametrize("key", sorted(golden.load()["gops"]))
def test_decode_gops_parallel_cuda(cuda, key, launches):
    """Lockstep GOP-parallel decode on the card against dsv2_tpu's
    per-frame digests, at widths 1 and every GOP."""
    import hashlib
    import io
    from dsv2_tpu_torch.parallel import gop
    want = golden.load()["gops"][key]["frames"]
    data = golden.read_stream(key)
    for width in (1, None):
        n0 = sum(launches.filters().values())
        frames = gop.decode_gops_parallel(io.BytesIO(data), width=width,
                                          device=cuda)
        assert [hashlib.sha256(f.tobytes()).hexdigest()
                for f in frames] == want
        assert sum(launches.filters().values()) > n0


def test_decode_gops_parallel_corrupt_cuda(cuda):
    """The 8 corrupt-stream trials (2 GOPs each) through the lockstep
    decode on the card: their corrupt planes share a flush's key and
    batch; every frame against dsv2_tpu's sequential decode (the GOPs
    are independent, so the frames are the same)."""
    import hashlib
    import io
    from dsv2_tpu_torch.parallel import gop
    gold = golden.load()
    for i, data in enumerate(golden.corrupt_streams()):
        frames = gop.decode_gops_parallel(io.BytesIO(data), device=cuda)
        assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] \
            == [d for _, d in gold[golden.corrupt_key(i)]["frames"]], i


# the single stream's one-frame P chain as a CUDA graph (codec/devsteps
# GraphedStep): its streams against the unwrapped step's


def _live(bench_cfg, nframes, seed):
    """A seeded clip of a benchmark configuration (codecbench/clip.py)."""
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from codecbench import clip, harness
    cfg = harness.Bench(repo).config(bench_cfg)
    return cfg, clip.make_clip(cfg["width"], cfg["height"], nframes,
                               cfg["subsamp"], seed)


def _encode_live(cfg, frames, device, filters=None):
    """One stream of `frames` through Encoder.encode_frame at -gop=30;
    `filters` sets do_inter_filter per frame (1 on, 0 off, -1 auto)."""
    from codecbench import program
    enc = program.encoder(cfg, 30, device)
    out = []
    for i, planes in enumerate(frames):
        if filters is not None:
            enc.do_inter_filter = filters[i % len(filters)]
        out += enc.encode_frame(planes)
    out += enc.end_of_stream()
    return b"".join(out)


@pytest.fixture
def eager_p_chain(monkeypatch):
    """eager_p_chain(fn) runs fn with the unwrapped P chain step in place
    of its CUDA graph."""
    from dsv2_tpu_torch.codec import devsteps

    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(devsteps, "p_chain_step",
                      lambda cfg, device: devsteps.make_p_chain_packed(*cfg))
            return fn()
    return run


@pytest.fixture
def fresh_graphs():
    """No P chain graph captured before the test."""
    from dsv2_tpu_torch.codec import devsteps
    with devsteps._GRAPHS_LOCK:
        devsteps._GRAPHS.clear()
    yield


def test_p_chain_graph_stream_equals_eager(cuda, eager_p_chain,
                                           fresh_graphs, monkeypatch):
    """FHD, 1 I + 6 P frames at -gop=30, the inter filter on, off and
    auto in turn and both temporal MC parities: the graphed encoder's
    stream is the unwrapped step's, byte for byte."""
    from dsv2_tpu_torch.codec import devsteps
    cfg, frames = _live("fhd420_qp60_gop30", 7, 2 ** 31 + 18)
    seen = []
    ints = devsteps.p_chain_ints

    def spied(grids, *scal):
        seen.append(scal)
        return ints(grids, *scal)
    monkeypatch.setattr(devsteps, "p_chain_ints", spied)
    filt = (1, 0, -1)
    want = eager_p_chain(lambda: _encode_live(cfg, frames, cuda, filt))
    assert {s[1] for s in seen} == {0, 1}        # tmc parity
    assert {s[4] for s in seen} == {0, 1}        # do_filter
    got = _encode_live(cfg, frames, cuda, filt)
    assert got == want
    assert len(seen) == 12


def test_p_chain_graph_shared_by_encoders(cuda, eager_p_chain,
                                          fresh_graphs):
    """CIF streams through one graph: two interleaved frame by frame in
    one thread, then nine on nine threads at once (with a short switch
    interval), each stream its eager bytes (a replay's outputs are copied
    out before the next)."""
    import sys
    import threading
    from codecbench import program
    runs = [_live("cif420_qp60", 6, 2 ** 31 + 5 + i) for i in range(3)]
    want = [eager_p_chain(lambda c=c, f=f: _encode_live(c, f, cuda))
            for c, f in runs]
    assert len(set(want)) == 3
    encs = [program.encoder(c, 30, cuda) for c, _ in runs[:2]]
    outs = [[], []]
    for i in range(6):
        for k in range(2):
            outs[k] += encs[k].encode_frame(runs[k][1][i])
    got = [b"".join(o + e.end_of_stream()) for o, e in zip(outs, encs)]
    assert got == want[:2]
    n = 9
    got = [None] * n

    def job(k):
        got[k] = _encode_live(*runs[k % 3], cuda)
    threads = [threading.Thread(target=job, args=(k,)) for k in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == [want[k % 3] for k in range(n)]


def test_p_chain_graph_counts(cuda, eager_p_chain, fresh_graphs, launches):
    """Two FHD jobs of 1 I + 3 P frames: one capture, a replay for every
    P frame but the first, and the launches the replays credit equal the
    unwrapped step's."""
    from dsv2_tpu_torch.utils import trace
    cfg, frames = _live("fhd420_qp60_gop30", 4, 2 ** 31 + 3)
    want = eager_p_chain(lambda: _encode_live(cfg, frames, cuda))
    eager = {k: v for k, v in trace.counters().items()
             if k.startswith("launch.")}
    assert eager["launch.vk_chain"] > 0 and eager[
        "launch.wavefront_filter.luma"] == 3
    trace.reset()
    for _ in range(2):
        assert _encode_live(cfg, frames, cuda) == want
    got = trace.counters()
    assert got["graph.capture.p_chain"] == 1
    assert got["graph.replay.p_chain"] == 2 * 3 - 1
    assert {k: v for k, v in got.items() if k.startswith("launch.")} == {
        k: 2 * v for k, v in eager.items()}
