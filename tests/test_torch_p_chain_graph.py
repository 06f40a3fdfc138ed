"""torch port: the one-frame P chain step is safe to capture as a CUDA
graph (codec/devsteps.make_p_chain_packed, replayed by GraphedStep on the
card).

A graph replays the ops its capture recorded, with the arguments they
had then: every value that changes from frame to frame must reach the
step as a device tensor, never as a Python value an op bakes in, and
nothing in it may wait for the device. On the CPU, at the tiny geometry,
the aten ops of the packed step are recorded (TorchDispatchMode) for
frames that differ in q, temporal MC parity, the filter q and threshold
and the filter flag: the ops and their non-tensor arguments must be the
same, no op reads a tensor's value back to the host, and no upload
helper (`xfer.put`) runs. The plain stand-ins of kernels 1 and 2 (the vk
chain and the filter wavefront, one launch each on the card) are
recorded as one entry each, not op by op. The packed step's outputs
equal the unwrapped step's, and the encoder's streams through it stay
the golden ones."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import assert_same, tt
import torch_port_golden as golden  # after torch_parity (sys.path)
import test_torch_lockstep_batch as lb
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.codec import devsteps
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.ops import filters, scan_pl
from dsv2_tpu_torch.parallel import xfer

CFG = (64, 48, K.SUBSAMP_420, lb.BLK, lb.BLK, False, K.PSY_ALL, lb.LEVELS, 1)
# (q, tmc, fq, fthresh, do_filter) of frames that differ in each
FRAMES = [(700, 1, 900, 160, 1), (1500, 0, 1100, 128, 0),
          (2400, 1, 1536, 96, 0), (60, 0, 542, 192, 1)]


def _arg(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", a.dtype, tuple(a.shape), a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_arg(v) for v in a)
    return a


class _Ops(TorchDispatchMode):
    """The aten ops run under it with their arguments, tensors by dtype,
    shape and device; a stand-in of a kernel is one entry."""

    def __init__(self):
        super().__init__()
        self.ops, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.ops.append((str(func), _arg(args),
                             _arg(sorted(kwargs.items()))))
        return func(*args, **kwargs)

    def standin(self, name, fn):
        def run(*args):
            self.ops.append((name, _arg(args)))
            self.paused = True
            try:
                return fn(*args)
            finally:
                self.paused = False
        return run


def _inputs(scalars):
    """The packed step's inputs for lane 0's planes, grids and maps of
    test_torch_lockstep_batch.p_lanes with the frame's scalars."""
    a = lb.p_lanes("tiny", 3, 1)[0]
    grids = np.stack([t.numpy().astype(np.int32) for t in a[2:10]])
    return a[0], a[1], grids, tt(devsteps.p_chain_ints(grids, *scalars))


@pytest.fixture
def puts(monkeypatch):
    calls = []
    put = xfer.put

    def counted(v, device):
        calls.append(device)
        return put(v, device)
    monkeypatch.setattr(xfer, "put", counted)
    return calls


def test_p_chain_ops_do_not_depend_on_the_frames_values(monkeypatch, puts):
    step = devsteps.make_p_chain_packed(*CFG)
    srcs, refs, _, ints = _inputs(FRAMES[0])
    step(srcs, refs, ints)   # builds the cached tables first
    vk, wf = scan_pl.vk_chain_plain, filters.wavefront_filter_plain
    seqs = []
    for scalars in FRAMES:
        srcs, refs, _, ints = _inputs(scalars)
        mode = _Ops()
        monkeypatch.setattr(scan_pl, "vk_chain_plain",
                            mode.standin("vk_chain", vk))
        monkeypatch.setattr(filters, "wavefront_filter_plain",
                            mode.standin("wavefront", wf))
        with mode:
            step(srcs, refs, ints)
        seqs.append(mode.ops)
    assert puts == []
    names = [op[0] for op in seqs[0]]
    assert names.count("vk_chain") == 3
    assert names.count("wavefront") == 2
    # no value read back to the host, no data-dependent shape
    assert not [n for n in names if "_local_scalar_dense" in n
                or "nonzero" in n or "masked_select" in n]
    for i, ops in enumerate(seqs[1:], 1):
        assert len(ops) == len(seqs[0]), i
        for k, (a, b) in enumerate(zip(seqs[0], ops)):
            assert a == b, (i, k, a, b)


@pytest.mark.parametrize("frame", range(len(FRAMES)))
def test_p_chain_packed_equals_the_step(frame, puts):
    """The packed step's outputs are the unwrapped step's with the frame's
    values as Python ints, and it uploads nothing."""
    q, tmc, fq, fthresh, do_filter = FRAMES[frame]
    srcs, refs, grids, ints = _inputs(FRAMES[frame])
    got = devsteps.make_p_chain_packed(*CFG)(srcs, refs, ints)
    assert puts == []
    g = [tt(a) for a in grids]
    want = devsteps.make_p_chain_step(*CFG)(
        srcs, refs, *g[:5], g[5].to(torch.uint8), g[6] != 0, g[7] != 0,
        torch.tensor(q, dtype=torch.int32), tmc, fq, fthresh, do_filter)
    for k in range(3):
        assert_same(got[k], want[k], "output %d" % k)
    for k in want[3]:
        assert_same(got[3][k], want[3][k], k)


def test_p_encode_golden_uploads_nothing_in_the_step(monkeypatch, puts):
    """The encoder's P frames go through the packed step (one call each,
    no upload inside it), and the stream is the golden one."""
    from dsv2_tpu_torch import cli
    name, qp, gop, nfr = golden.P_CASES[0]
    inside = []
    chain = devsteps.p_chain_step

    def spied(cfg, device):
        step = chain(cfg, device)

        def run(*args):
            n0 = len(puts)
            out = step(*args)
            inside.append(len(puts) - n0)
            return out
        return run
    monkeypatch.setattr(devsteps, "p_chain_step", spied)
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames[:nfr], meta, qp, gop=gop, device="cpu")
    want = golden.load()[golden.p_key(golden.P_CASES[0])]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    assert inside == [0] * (nfr - 1)
