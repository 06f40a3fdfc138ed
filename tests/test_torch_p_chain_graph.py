"""torch port: the P chain step's flush of L lanes is safe to capture as
a CUDA graph (codec/devsteps.make_p_chain_lanes, run by
parallel/dynbatch.flush_step, which on the card replays a GraphedStep of
it per lane count: the single stream's one-lane flush and the lockstep
flusher's L-lane runs).

A graph replays the ops its capture recorded, with the arguments they
had then: every value that changes from frame to frame must reach the
step as a device tensor (the lane's p_chain_ints), never as a Python
value an op bakes in, and nothing in it may wait for the device. On the
CPU, at the tiny geometry, the aten ops of flushes of 1, 3 and 8 lanes
are recorded (TorchDispatchMode) for lanes that differ, lane by lane and
flush by flush, in q, temporal MC parity, the filter q and threshold,
the filter flag, the motion field and the planes: at each lane count
the ops and their non-tensor arguments must be the same, no op reads a
tensor's value back to the host, and no upload (`xfer.upload`) runs
inside the step. The plain stand-ins of kernels 1 and 2 (the vk chain
and the filter wavefront, one launch each on the card) are recorded as
one entry each, not op by op. Each frame's one-lane flush equals its
lane of one flush of every frame, and the encoder's streams through the
runner stay the golden ones."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parity  # noqa: F401
import torch_port_golden as golden  # after torch_parity (sys.path)
import test_torch_lockstep_batch as lb
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.codec import devsteps
from dsv2_tpu_torch.core import constants as K
from dsv2_tpu_torch.ops import filters, scan_pl
from dsv2_tpu_torch.parallel import dynbatch, xfer

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


def _lanes():
    """One lane per frame of FRAMES: the planes, grids and maps of
    test_torch_lockstep_batch.p_lanes with the frame's scalars."""
    return lb.p_lanes("tiny", 3, len(FRAMES), FRAMES)


@pytest.fixture
def uploads(monkeypatch):
    calls = []
    upload = xfer.upload

    def counted(a, device):
        calls.append(device)
        return upload(a, device)
    monkeypatch.setattr(xfer, "upload", counted)
    return calls


def _flushes(nlanes):
    """Flushes of nlanes lanes: one lane, a flush per frame of FRAMES;
    more, three flushes whose lanes take the scalars of
    test_torch_lockstep_batch.SCALARS in turn (each lane and flush its
    own) and planes and motion fields of a seed per flush."""
    if nlanes == 1:
        return [[lane] for lane in _lanes()]
    sc = [(q, K.temporal_mc(fno), fq, fthresh, do_filter)
          for q, fq, fthresh, do_filter, fno in lb.SCALARS]
    return [lb.p_lanes("tiny", 10 + f, nlanes,
                       [sc[(f * nlanes + i) % len(sc)]
                        for i in range(nlanes)]) for f in range(3)]


@pytest.mark.parametrize("nlanes", [1, 3, 8])
def test_p_chain_ops_do_not_depend_on_the_frames_values(monkeypatch,
                                                         uploads, nlanes):
    step = devsteps.make_p_chain_lanes(CFG)
    flushes = _flushes(nlanes)
    step(flushes[0])   # builds the cached tables first
    vk, wf = scan_pl.vk_chain_plain, filters.wavefront_filter_plain
    seqs = []
    for lanes in flushes:
        mode = _Ops()
        monkeypatch.setattr(scan_pl, "vk_chain_plain",
                            mode.standin("vk_chain", vk))
        monkeypatch.setattr(filters, "wavefront_filter_plain",
                            mode.standin("wavefront", wf))
        with mode:
            step(lanes)
        seqs.append(mode.ops)
    assert uploads == []
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


@pytest.mark.parametrize("first,then", [(8, 3), (1, 8), (3, 1)])
def test_p_chain_tables_do_not_depend_on_the_lane_count(uploads, first,
                                                        then):
    """On the card the key's first flush, of any lane count, runs eagerly
    and every other lane count captures at its first flush
    (dynbatch.flush_step): after a flush of `first` lanes, the first
    flush of `then` lanes builds no device table (ops/tint.on_device)
    and uploads nothing, so nothing in its capture would wait for the
    device."""
    from dsv2_tpu_torch.ops import tint
    step = devsteps.make_p_chain_lanes(CFG)
    step(_flushes(first)[0])
    built = tint._on_device.cache_info().misses
    step(_flushes(then)[1])
    assert tint._on_device.cache_info().misses == built
    assert uploads == []


def test_replay_stand_ins_reach_a_wrapped_launch(monkeypatch):
    """ops/_kernels.stand_ins: the launches noted in the block stand in,
    at a replay, for the launches a graph's replay makes. Left
    unwrapped, a stand-in calls nothing; once someone wraps the module's
    launch wrapper, it calls the wrapper with the launch's arguments,
    read at the replay, and `replayed` true."""
    from dsv2_tpu_torch.ops import _kernels
    arg = [1]
    with _kernels.stand_ins() as made:
        _kernels._stand_in("vk_chain", lambda: ("thr", list(arg)))
        _kernels._stand_in("wavefront_filter", lambda: (2, "lay"))
    assert _kernels._stand_in("vk_chain", lambda: ()) is None  # no block
    assert len(made) == 2
    for fn in made:
        fn()    # unwrapped: nothing called (the wrappers refuse these)
    calls = []
    monkeypatch.setattr(_kernels, "vk_chain",
                        lambda *a, **k: calls.append(("vk", a, k)))
    monkeypatch.setattr(_kernels, "wavefront_filter",
                        lambda *a, **k: calls.append(("wf", a, k)))
    arg[0] = 5
    for fn in made:
        fn()
    assert calls == [("vk", ("thr", [5]), {"replayed": True}),
                     ("wf", (2, "lay"), {"replayed": True})]


def _storages(x):
    return {t.untyped_storage().data_ptr() for t in dynbatch.tensors(x)}


@pytest.mark.parametrize("nlanes", [1, 8])
def test_copy_out_clones_each_base_once(nlanes):
    """A replay's copy-out (dynbatch._copied with bases): the LaneOuts of
    a flush come back equal and laid out as they were, with one clone
    per storage they view (the blob and metadata every lane shares, the
    (L, ...) stacks of scans and chain planes), none of them the
    outputs' own, which the next replay writes."""
    out = devsteps.make_p_chain_lanes(CFG)(_flushes(nlanes)[0])
    got = dynbatch._copied(out, {})
    assert len(_storages(got)) == len(_storages(out))
    assert not _storages(got) & _storages(out)
    for g, w in zip(dynbatch.tensors(got), dynbatch.tensors(out)):
        assert (g.dtype, g.shape, g.stride()) == (w.dtype, w.shape,
                                                  w.stride())
        assert torch.equal(g, w)
    for i in range(nlanes):
        lb._check_lane_out(got[i], out[i], i)


@pytest.mark.parametrize("frame", range(len(FRAMES)))
def test_p_chain_packed_equals_the_step(frame, uploads):
    """Frame `frame` as a flush of one lane (the runner's, outside
    lockstep) equals its lane of one flush of every frame of FRAMES, and
    neither uploads anything."""
    lanes = _lanes()
    want = devsteps.make_p_chain_lanes(CFG)(lanes)[frame]
    got = devsteps.run_one(("p_chain", CFG), devsteps.make_p_chain_lanes,
                           lanes[frame], "cpu")
    assert uploads == []
    assert got.lane == 0 and want.lane == frame
    lb._check_lane_out(want, got, frame)


def test_p_encode_golden_uploads_nothing_in_the_step(monkeypatch, uploads):
    """The encoder's P frames go through the runner as a one-lane flush of
    the P chain (one call each, no upload inside it), and the stream is
    the golden one."""
    from dsv2_tpu_torch import cli
    name, qp, gop, nfr = golden.P_CASES[0]
    inside = []
    run_one = devsteps.run_one

    def spied(key, builder, args, device):
        n0 = len(uploads)
        out = run_one(key, builder, args, device)
        if key[0] == "p_chain":
            inside.append(len(uploads) - n0)
        return out
    monkeypatch.setattr(devsteps, "run_one", spied)
    frames, meta = read_y4m(golden.input_path(name))
    data = golden.encode(cli, frames[:nfr], meta, qp, gop=gop, device="cpu")
    want = golden.load()[golden.p_key(golden.P_CASES[0])]
    assert golden.digest(data) == {k: want[k] for k in ("sha256", "length")}
    assert inside == [0] * (nfr - 1)
