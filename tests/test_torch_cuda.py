"""torch port on the card: the hand-written CUDA kernels (the vk chain,
the in-loop filter wavefront) against their plain versions, and the
device encode and decode paths against the golden streams.

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


@pytest.mark.parametrize("nb", [1, 3, 16, 40])
def test_vk_kernel_vs_plain(cuda, nb):
    from dsv2_tpu_torch.ops import scan_pl
    rng = np.random.default_rng(nb)
    npad = 8192
    thr = rng.integers(0, 60, (npad, nb)).astype(np.int32)
    thr[rng.random((npad, nb)) < 0.4] = 0
    s0 = rng.integers(0, 3000, nb).astype(np.int32)
    nnz = np.maximum(s0, rng.integers(0, npad + 100, nb)).astype(np.int32)
    args = [tt(a) for a in (thr, s0, nnz)]
    want = scan_pl.vk_chain_plain(*args)
    n0 = scan_pl.vk_chain.launches
    got = scan_pl.vk_chain(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert scan_pl.vk_chain.launches == n0 + 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)


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
@pytest.mark.parametrize("w,h,blk", [(352, 288, 16), (640, 360, 32)])
def test_filter_kernel_vs_plain(cuda, kind, nb, w, h, blk):
    from dsv2_tpu_torch.ops import filters
    fn = getattr(filters, kind + "_filter_graph")
    args = _filter_inputs(kind, w, h, blk, nb, w + nb)
    want = fn(*args)
    n0 = filters.wavefront_filter.launches[kind]
    got = fn(*(a.to(cuda) if isinstance(a, torch.Tensor) else a
               for a in args))
    torch.cuda.synchronize()
    assert filters.wavefront_filter.launches[kind] == n0 + 1
    assert got.dtype == torch.uint8 and got.is_cuda
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, args[4 if kind == "intra" else
                                      (7 if kind == "luma" else 6)])


def test_filter_kernel_rejects(cuda):
    from dsv2_tpu_torch.ops import filters
    lay = filters._layout(1024, 1024, 128, 128, 8, 8)   # 296 KB of windows
    plane = torch.zeros((1, lay.HP, lay.WP), dtype=torch.int32, device=cuda)
    props = torch.zeros((1, 5, 8, 8), dtype=torch.int32, device=cuda)
    scal = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        filters.wavefront_filter("chroma", lay, plane, props, scal)
    lay = filters._layout(64, 48, 4, 4, 15, 11)
    plane = torch.zeros((1, lay.HP, lay.WP), dtype=torch.int32, device=cuda)
    props = torch.zeros((1, 1, 11, 15), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane, props.cpu(), scal)
    with pytest.raises(ValueError):
        filters.wavefront_filter("intra", lay, plane.transpose(1, 2)
                                 .contiguous().transpose(1, 2), props, scal)


@pytest.mark.parametrize("key", ["tiny64x48_422_4f@qp60_gop4",
                                 "cif352x288_420_12f@qp60_gop12"])
def test_decode_p_golden_cuda(cuda, key):
    from dsv2_tpu_torch.codec import decoder
    from dsv2_tpu_torch.ops import filters
    from dsv2_tpu_torch.utils import y4m
    data = golden.read_stream(key)
    n0 = dict(filters.wavefront_filter.launches)
    y = golden.decoded_y4m(decoder, y4m, data,
                           decoder=decoder.Decoder(device=cuda))
    want = golden.load()[key]["decode"]
    assert golden.digest(y) == want
    for k in ("luma", "chroma"):
        assert filters.wavefront_filter.launches[k] > n0[k]


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
