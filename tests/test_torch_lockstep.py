"""torch port: lockstep multi-stream P encode
(dsv2_tpu_torch/parallel/dynbatch.encode_streams_lockstep), mirroring
tests/test_parallel.py's lockstep test: tiny64x48_420_6f as 3 streams of
-gop=2 (an I and a P frame each) with width 4. Every lane must equal the
port's sequential encode of its frames and dsv2_tpu's (JAX on the CPU,
its host motion search), with no end-of-stream packet, for the "gang"
and "pallas" motion-search backends, in one group and in two, and in
one group narrower than the streams (flushes split into runs of at most
width lanes). Plus: too many streams for groups > 1 of width raises,
and a lane's error reaches the caller without leaving a thread hanging.
"""
import threading

import pytest

from torch_parity import REPO  # noqa: F401  (sys.path for the golden tool)
import torch_port_golden as golden
from dsv2_tpu_torch import cli
from dsv2_tpu_torch.cli import read_y4m
from dsv2_tpu_torch.ops import hme_gang
from dsv2_tpu_torch.parallel import dynbatch

NAME, QP, GOP = "tiny64x48_420_6f", 60, 2
_seq = {}


def _streams():
    frames, meta = read_y4m(golden.input_path(NAME))
    return [frames[i:i + GOP] for i in range(0, len(frames), GOP)], meta


def _factory(meta, backend):
    def make():
        enc = cli.make_encoder(meta, cli.default_enc_opts(qp=QP, gop=GOP),
                               device="cpu")
        enc.hme_backend = backend
        return enc
    return make


def _sequential():
    """(the port's, dsv2_tpu's) sequential streams, computed once."""
    if not _seq:
        from dsv2_tpu import cli as jcli
        streams, meta = _streams()
        _seq["port"] = [golden.encode(cli, s, meta, QP, gop=GOP, eos=False,
                                      device="cpu") for s in streams]
        _seq["jax"] = [golden.encode(jcli, s, meta, QP, gop=GOP, eos=False)
                       for s in streams]
    return _seq["port"], _seq["jax"]


def _run(fn, timeout=300):
    """fn() in a thread that must end within `timeout` s; returns its
    result or raises its error."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as exc:
            box["err"] = exc
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "lockstep encode hung"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("backend", ["gang", "pallas"])
@pytest.mark.parametrize("groups", [1, 2])
def test_lockstep_matches_sequential(backend, groups):
    port, jax_ = _sequential()
    assert port == jax_
    streams, meta = _streams()
    width = 4 if groups == 1 else 2
    got = _run(lambda: dynbatch.encode_streams_lockstep(
        streams, _factory(meta, backend), width=width, groups=groups))
    assert [len(x) for x in got] == [len(x) for x in port]
    assert got == port


def test_lockstep_too_many_streams_raises():
    """groups > 1 that cannot hold every stream raises (the twin drops
    the streams past groups * width)."""
    streams, meta = _streams()
    with pytest.raises(ValueError, match="do not fit"):
        dynbatch.encode_streams_lockstep(streams, _factory(meta, "gang"),
                                         width=1, groups=2)


@pytest.mark.parametrize("backend", ["gang", "pallas"])
def test_lockstep_width_below_streams(backend):
    """One group runs every stream whatever its width: 3 streams at
    width 2 flush in runs of at most 2 lanes, each stream's bytes equal
    to its sequential encode. Each run takes the step of its lane count
    from dynbatch.flush_step, on the lanes' device: the P chain's runs
    of 2 and 1 lanes."""
    port, _ = _sequential()
    streams, meta = _streams()
    sizes = []
    steps = []
    make_gang = hme_gang.make_motion_est
    flush_step = dynbatch.flush_step

    def counting(cfg):
        fn = make_gang(cfg)

        def f(lanes):
            sizes.append(len(lanes))
            return fn(lanes)
        return f

    def spied(key, builder, nlanes, device):
        steps.append((key[0], nlanes, str(device)))
        return flush_step(key, builder, nlanes, device)
    hme_gang.make_motion_est = counting
    dynbatch.flush_step = spied
    try:
        got = _run(lambda: dynbatch.encode_streams_lockstep(
            streams, _factory(meta, backend), width=2, groups=1))
    finally:
        hme_gang.make_motion_est = make_gang
        dynbatch.flush_step = flush_step
    assert got == port
    if backend == "gang":
        assert sizes and max(sizes) == 2, sizes
    assert {s for s in steps if s[0] == "p_chain"} == {
        ("p_chain", 2, "cpu"), ("p_chain", 1, "cpu")}, steps


def test_lockstep_lane_error_reaches_caller():
    """A lane failing in its host code, and a flush failing on the device
    step, both reach the caller; the other lanes finish or fail, none
    hangs."""
    streams, meta = _streams()
    bad = [streams[0], [streams[1][0], None], streams[2]]  # no frame
    with pytest.raises(TypeError):
        _run(lambda: dynbatch.encode_streams_lockstep(
            bad, _factory(meta, "gang"), width=4))

    def boom(cfg):
        raise RuntimeError("flush failed")
    with pytest.raises(RuntimeError, match="flush failed"):
        _run(lambda: _with_builder(boom, streams, meta))


def _with_builder(builder, streams, meta):
    """The lockstep encode with `builder` in place of every encode chain
    step's builder."""
    from dsv2_tpu_torch.codec import devsteps
    names = ("make_input_prep_lanes", "make_i_chain_lanes",
             "make_p_chain_lanes")
    orig = [getattr(devsteps, n) for n in names]
    for n in names:
        setattr(devsteps, n, builder)
    try:
        return dynbatch.encode_streams_lockstep(
            streams, _factory(meta, "gang"), width=4)
    finally:
        for n, f in zip(names, orig):
            setattr(devsteps, n, f)
