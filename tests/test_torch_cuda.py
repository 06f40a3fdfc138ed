"""torch port on the card: the hand-written CUDA vk-chain kernel against
its plain version, and the device path against the golden streams.

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
    from dsv2_tpu.ops import hzcc
    from dsv2_tpu_torch.ops import scan_pl
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
