"""Lockstep device-call batching for multi-stream encoding and decoding
(port of `dsv2_tpu/parallel/dynbatch.py`).

N per-GOP encoder (decoder) threads run the unmodified per-frame
pipeline; whenever a thread reaches a device step (input prep, motion
search, frame chain step) it submits (key, builder, args) here and
blocks. When every running
thread is blocked on a submission, the last one to block becomes the
flusher: for each key it picks, it runs builder(cfg) ONCE over the queued
lanes and hands each thread its lane of the output.

Torch has no vmap over the port's hand-written kernels, so a builder
takes the lanes explicitly: builder(cfg) -> fn(lanes), `lanes` the list
of the queued argument tuples; fn returns a list with one output per
lane, or a dict of tensors with a leading lane dimension (lane i gets
{k: v[i]}, views that cost nothing). The motion search of a flush is one
launch per pyramid level for every lane (ops/hme_gang, key "hme_gang");
the input prep and the chain steps of encode and decode are such
builders (codec/devsteps.make_*_lanes): one vk launch per plane and one
filter launch per filter kind for every lane of the flush. Outside
lockstep an encoder or decoder runs each step as a flush of one lane
(codec/devsteps.run_one), so every step has this one form; in and out
of lockstep a flush of L lanes runs the callable that `flush_step` gives
for (key, L, device): on the card a GRAPHED kind's (the P chain's) is
the replay of a CUDA graph per lane count (`GraphedStep`). The
twin pads every batch to `width` with copies of lane 0 so that each XLA
program compiles once; nothing compiles per shape here, so the port runs
the lanes it has. `run_lanes` runs the lane threads of a group, for
encode here and for decode in parallel/gop.decode_gops_parallel.

Threads and the device: each lane's host work runs in its own thread,
the flush in whichever thread blocked last. Every thread launches on
the device's default stream (torch's current stream, never changed
here), so a lane's later fetch of its outputs waits for the batched
launch. Results are byte-identical to encoding each stream sequentially:
scheduling never changes a stream's arithmetic.

Traced (utils/trace), the lockstep cycle is two spans on the wall clock:
`lockstep.gather`, from the end of the batcher's previous flush (its
creation, for the first) to the moment the last lane blocks, and
`lockstep.flush`, the flush itself in the flusher thread (ids: `flush`,
its sequence number in the process, `key`, `lanes`; its children
`lockstep.dispatch.<key>`, one per run of at most `width` lanes, carry
their `lanes`). Every lane blocks until the flush, so a run's wall time
is the sum of the two. The calling thread's span `lockstep.group` runs
from the batcher's creation to its last lane's end. A lane's span open
at its submission is tagged with the flush that served it; counters
`lockstep.flushes.<key>` and `lockstep.lanes.<key>` count the flushes
and their lanes per key.
"""
import itertools
import threading

import torch

from ..ops import _kernels
from ..utils import trace
from ..utils.trace import stage
from . import xfer

_FLUSH_IDS = itertools.count(1)   # flush sequence numbers in the process


def lane_of(out, i):
    """Lane i of a builder's output (see the module docstring)."""
    if isinstance(out, list):
        return out[i]
    return {k: v[i] for k, v in out.items()}


def tensors(x):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)


def _wait(out):
    """Block until the device has run the flush (the current stream of
    the first CUDA tensor of the output)."""
    t = next((t for t in tensors(out) if t.is_cuda), None)
    if t is not None:
        xfer.wait_stream(t)


def _copied(x, bases=None):
    """A nest of tuples (named ones too), lists and dicts with each tensor
    cloned. With `bases`, a dict, each base is cloned once and the
    tensors that view it are views of that clone, laid out as they were:
    the lanes of a flush share its blob and view its (L, ...) stacks, so
    copying them costs a copy per base, whatever L is."""
    if isinstance(x, torch.Tensor):
        if bases is None:
            return x.clone()
        base = x if x._base is None else x._base
        c = bases.get(id(base))
        if c is None:
            c = bases[id(base)] = base.clone()
        if base is x:
            return c
        if c.stride() != base.stride() or x.dtype != base.dtype:
            return x.clone()
        return c.as_strided(x.shape, x.stride(), c.storage_offset()
                            + x.storage_offset() - base.storage_offset())
    if isinstance(x, dict):
        return {k: _copied(v, bases) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        vals = [_copied(v, bases) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


# torch.cuda.graph captures on one stream of the process's, whatever
# step captures: one capture at a time
_CAPTURE_LOCK = threading.Lock()


class _KeyGraphs:
    """The GraphedSteps of one step key on one device, by lane count
    (`steps`), and whether one of them has run its body eagerly
    (`warm`): the first call among them does, under `lock`, which holds
    the first calls of the others until it has."""

    def __init__(self):
        self.lock, self.warm, self.steps = threading.Lock(), False, {}


class GraphedStep:
    """A device step replayed as a CUDA graph. The first call of the
    steps that share `key_graphs` (a _KeyGraphs: the step's key at other
    lane counts; the step alone without it) runs `body` eagerly: its
    tables are built and uploaded, its kernels loaded, none of them by
    lane count. Each step's first call after that captures it into
    static copies of its inputs, and that call and each later one copy
    their inputs into those, replay the graph on the current stream and
    return copies of its outputs (a clone per base they view), which no
    later replay writes. A lock serializes copy-in, replay and copy-out,
    and a stream waits for the last copy-out before its copy-in, so
    callers on several threads and streams stay apart; captures, of any
    step, take one process-wide lock. The capture notes the counts the
    body makes (trace.collect: its kernels' `launch.*`) and each replay
    credits them, with `graph.replay.<name>`; the capture counts
    `graph.capture.<name>`. Each replay but the capturing call's also
    calls the stand-ins of the launches the capture made
    (ops/_kernels.stand_ins), so whoever wraps a launch wrapper sees a
    replayed launch as it sees an eager one."""

    def __init__(self, name, body, device, key_graphs=None):
        self.name, self.body, self.device = name, body, device
        self._key = _KeyGraphs() if key_graphs is None else key_graphs
        self._lock = threading.Lock()
        self._graph = self._ins = self._outs = self._done = None
        self._counts, self._stand_ins = {}, []

    def __call__(self, *inputs):
        with self._lock, torch.cuda.device(self.device):
            capturing = self._graph is None
            if capturing:
                with self._key.lock:
                    if not self._key.warm:
                        out = self.body(*inputs)
                        self._key.warm = True
                        return out
                self._capture(inputs)
            else:
                torch.cuda.current_stream().wait_event(self._done)
                for s, t in zip(tensors(self._ins), tensors(inputs)):
                    if s.shape != t.shape or s.dtype != t.dtype:
                        raise ValueError("%s graph takes %s %s, got %s %s"
                                         % (self.name, s.dtype,
                                            tuple(s.shape), t.dtype,
                                            tuple(t.shape)))
                    s.copy_(t)
            self._graph.replay()
            trace.count("graph.replay." + self.name)
            for k, n in self._counts.items():
                trace.count(k, n)
            if not capturing:
                for fn in self._stand_ins:
                    fn()
            out = _copied(self._outs, {})
            self._done.record()
            return out

    def _capture(self, inputs):
        self._ins = _copied(inputs)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            # torch.cuda.graph synchronizes the device first: wait here,
            # counted, so that its wait finds the device idle
            xfer.wait_stream(next(tensors(self._ins)))
            with trace.collect() as made, _kernels.stand_ins() as calls, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._outs = self.body(*self._ins)
        self._graph, self._counts, self._stand_ins = graph, made, calls
        self._done = torch.cuda.Event()
        trace.count("graph.capture." + self.name)


# the step kinds (key[0]) whose flushes are CUDA graphs on the card: the
# P chain (codec/devsteps.make_p_chain_lanes)
GRAPHED = ("p_chain",)
_GRAPHS = {}      # (key, device) -> _KeyGraphs
_GRAPHS_LOCK = threading.Lock()


def flush_step(key, builder, nlanes, device):
    """The callable that runs a flush of `nlanes` lanes of step `key` on
    `device`, fn(lanes) -> one output per lane. On a CUDA device a
    GRAPHED kind (key[0]) is the process's GraphedStep of (key, nlanes,
    device), shared by every encoder and every lockstep batcher: the
    key's first flush, of any lane count, runs eagerly, and every lane
    count captures its graph at its first flush after that. Every other
    step, and every step on the CPU, is builder(key[1]), run eagerly."""
    dev = torch.device(device)
    if key[0] not in GRAPHED or dev.type != "cuda":
        return builder(key[1])
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _GRAPHS_LOCK:
        graphs = _GRAPHS.get((key, dev))
        if graphs is None:
            graphs = _GRAPHS[(key, dev)] = _KeyGraphs()
        step = graphs.steps.get(nlanes)
        if step is None:
            step = graphs.steps[nlanes] = GraphedStep(
                key[0], builder(key[1]), dev, graphs)
    return step


class LockstepBatcher:
    def __init__(self, width):
        """width: the most lanes one builder call runs; a flush with more
        lanes runs them width at a time."""
        self.width = width
        self._cond = threading.Condition()
        self._active = 0
        self._blocked = 0
        self._queues = {}             # key -> list of (entry, builder, ...)
        self._seq = 0                 # global submission counter
        self._gather_t0 = trace.mark()   # the first gather starts here

    def thread_begin(self):
        with self._cond:
            self._active += 1

    def thread_done(self):
        with self._cond:
            self._active -= 1
            if self._blocked and self._blocked >= self._active:
                self._flush_locked()

    def submit(self, key, builder, args, post=None, fetch=None):
        """Queue one lane; returns this lane's slice of the batched output.
        key = (kind, cfg): cfg hashable and identical for lanes batched
        together; builder(cfg) -> fn(lanes). post(out) -> out runs once per
        run of at most `width` lanes. fetch: whether the host reads the
        outputs (the twin's leaf selection for its merged fetch); a truthy
        fetch makes the flusher wait for the device, so the batched run
        shows in the lockstep.run stage. The first submission of a key
        fixes post and fetch."""
        # args, output, done, submission seq, the serving flush's id
        entry = [args, None, False, None, None]
        with self._cond:
            self._seq += 1
            entry[3] = self._seq
            self._queues.setdefault(key, []).append(
                (entry, builder, post, fetch))
            self._blocked += 1
            if self._blocked >= self._active:
                self._flush_locked()
            while not entry[2]:
                self._cond.wait()
        trace.tag(flush=entry[4])
        if isinstance(entry[1], BaseException):
            raise entry[1]
        return entry[1]

    def _pick_queues(self):
        """Choose which queues to flush. Full-width queues (a lane of every
        active thread) flush as one aligned batch. When every thread is
        blocked but no queue is full (the streams drifted out of phase,
        e.g. lanes whose reference was an I frame search under another
        key), release ONLY the queue holding the oldest submission: the
        stragglers advance, catch up with the group ahead, and the batches
        re-merge at full width. Flushing everything instead would lock the
        split in for good."""
        full = {k: v for k, v in self._queues.items()
                if len(v) >= self._active}
        if full:
            for k in full:
                del self._queues[k]
            return full
        oldest_key = min(self._queues,
                         key=lambda k: min(e[0][3] for e in
                                           self._queues[k]))
        return {oldest_key: self._queues.pop(oldest_key)}

    def _flush_locked(self):
        """Run the selected queues (caller holds the lock and is one of the
        blocked threads); an error reaches every waiter of its batch."""
        queues = self._pick_queues()
        nlanes = sum(len(v) for v in queues.values())
        self._blocked -= nlanes
        fid = next(_FLUSH_IDS)
        trace.record("lockstep.gather", self._gather_t0, flush=fid)
        with stage("lockstep.flush", flush=fid,
                   key="+".join(k[0] for k in queues), lanes=nlanes):
            for key, pending in queues.items():
                self._run_queue(key, pending, fid)
        self._gather_t0 = trace.mark()
        self._cond.notify_all()

    def _run_queue(self, key, pending, fid):
        kname = key[0]
        trace.count("lockstep.flushes." + kname)
        trace.count("lockstep.lanes." + kname, len(pending))
        try:
            _, builder, post, fetch = pending[0]
            if any(p[3] is not fetch for p in pending):
                raise ValueError("lockstep key %r: lanes submitted "
                                 "different fetch specs" % (kname,))
            # more lanes than width (one group holding more streams):
            # runs of at most width lanes, one after another, each by
            # the step of its lane count (flush_step)
            with stage("lockstep.stack.%s" % kname):
                runs = [pending[lo:lo + self.width]
                        for lo in range(0, len(pending), self.width)]
                first = next(tensors(pending[0][0][0]), None)
                dev = "cpu" if first is None else first.device
                steps = {len(run): flush_step(key, builder, len(run), dev)
                         for run in runs}
            for run in runs:
                with stage("lockstep.dispatch.%s" % kname, lanes=len(run)):
                    out = steps[len(run)]([e[0] for e, *_ in run])
                with stage("lockstep.run.%s" % kname):
                    if fetch:
                        _wait(out)
                if post is not None:
                    with stage("lockstep.post.%s" % kname):
                        out = post(out)
                for i, (e, *_) in enumerate(run):
                    e[1] = lane_of(out, i)
        except BaseException as exc:  # propagate to every waiter
            for e, *_ in pending:
                e[1] = exc
        for e, *_ in pending:
            e[2], e[4] = True, fid


def encode_streams_lockstep(stream_frames, enc_factory, width=None,
                            groups=1):
    """Encode independent GOP streams concurrently with lockstep device
    batching; returns the per-stream bytes in order (no end-of-stream
    packet: the caller that concatenates streams appends one).
    Byte-identical to encoding each stream sequentially.

    With one group every stream runs, whatever `width` is: a flush
    holding more lanes than `width` runs them `width` at a time (the
    twin vmaps them all in one call). groups > 1 pipelines the device:
    the streams split contiguously into `groups` independent batchers of
    `width` lanes each (default: the streams spread evenly), so one
    group's flush runs on the device while the other groups' threads do
    their host work; raises when groups * width streams cannot hold them
    all (the twin silently drops the rest)."""
    n = len(stream_frames)
    groups = max(int(groups), 1)
    width = width or -(-n // groups)
    if groups > 1 and groups * width < n:
        raise ValueError("%d streams do not fit %d groups of width %d"
                         % (n, groups, width))
    if groups == 1:
        return _encode_group(stream_frames, enc_factory, width)
    results = [None] * n
    errors = []

    def run_group(g):
        lo = g * width
        sf = stream_frames[lo:lo + width]
        if not sf:
            return
        try:
            results[lo:lo + len(sf)] = _encode_group(sf, enc_factory, width)
        except BaseException as exc:
            errors.append(exc)

    gthreads = [threading.Thread(target=run_group, args=(g,))
                for g in range(groups)]
    for t in gthreads:
        t.start()
    for t in gthreads:
        t.join()
    if errors:
        raise errors[0]
    return results


def run_lanes(n, width, lane_fn):
    """Run lane_fn(i, submit) for lanes i in range(n), each in a thread of
    its own, under one LockstepBatcher of `width` (submit is its
    submit); returns the lanes' results in order and raises the first
    lane's error once every thread has ended. Every lane counts as
    running before any thread starts, so the first flush waits for all
    of them (the twin counts each thread in from inside it, and an early
    thread can flush alone)."""
    with stage("lockstep.group", lanes=n):
        batcher = LockstepBatcher(width)
        results = [None] * n
        errors = []

        def run(i):
            try:
                results[i] = lane_fn(i, batcher.submit)
            except BaseException as exc:
                errors.append(exc)
            finally:
                batcher.thread_done()

        for _ in range(n):
            batcher.thread_begin()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results


def _encode_group(stream_frames, enc_factory, width):
    def lane(i, submit):
        trace.set_ids(lane=i)
        enc = enc_factory()
        enc.dev_submit = submit
        chunks = []
        for fr in stream_frames[i]:
            chunks.extend(enc.encode_frame(fr))
        return b"".join(chunks)

    return run_lanes(len(stream_frames), width, lane)
