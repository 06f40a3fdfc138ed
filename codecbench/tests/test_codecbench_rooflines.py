"""Each kernel's byte count against a count by hand at one small shape
(the counts are derived in the docstring of each rooflines/ file)."""
import os

import torch

from codecbench.harness import Bench, load_module

from conftest import REPO


def roofline(name):
    return load_module(os.path.join(REPO, "codecbench", "rooflines",
                                    name + ".py"), "rl_" + name)


def test_vk_chain_bytes_by_hand():
    rl = roofline("vk_chain")
    thr = torch.zeros((8, 2), dtype=torch.int32)
    call = rl.record(thr, torch.tensor([0, 2]), torch.tensor([5, 8]),
                     torch.zeros((8, 2), dtype=torch.int32), None, 256, 256,
                     128)
    # rows walked 5 + 6, read 4 B each; s0 and nnz 2 x 4 B each; every
    # row of vkpre written, 8 x 2 x 4 B
    assert rl.nbytes(call) == 4 * 11 + 16 + 64 == 124


def test_vk_chain_bytes_clip_to_rows():
    rl = roofline("vk_chain")
    thr = torch.zeros((4, 1), dtype=torch.int32)
    # s0 past nnz and nnz past npad walk nothing and 4 rows
    assert rl.nbytes(rl.record(thr, torch.tensor([3]), torch.tensor([1]))) \
        == 0 + 8 + 16
    assert rl.nbytes(rl.record(thr, torch.tensor([0]), torch.tensor([9]))) \
        == 16 + 8 + 16


def test_every_roofline_names_its_target_and_kernels():
    for name, rl in Bench(REPO).rooflines().items():
        mod, attr = rl.TARGET
        assert mod.startswith("dsv2_tpu_torch.")
        assert rl.KERNEL.pattern
        assert callable(rl.record) and callable(rl.nbytes)
        assert os.path.exists(os.path.join(
            REPO, "codecbench", "metrics", name + "_roofline.py"))


def test_kernel_patterns_match_profiler_names():
    vk = roofline("vk_chain").KERNEL
    for name in ("vk_spec_kernel(Geo)", "vk_resolve_kernel(Geo)",
                 "(anonymous namespace)::vk_final_kernel(Geo)"):
        assert vk.search(name)
    for name in ("void (anonymous namespace)::wavefront_kernel<1, false, "
                 "false>(unsigned char*, int const*)",
                 "void at::native::vectorized_elementwise_kernel",
                 "void gang_level0_kernel<32>(GangP)"):
        assert not vk.search(name)
