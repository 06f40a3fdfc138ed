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
(codec/devsteps.run_one), so every step has this one form. The
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

from ..utils import trace
from ..utils.trace import stage
from . import xfer

_FLUSH_IDS = itertools.count(1)   # flush sequence numbers in the process


def lane_of(out, i):
    """Lane i of a builder's output (see the module docstring)."""
    if isinstance(out, list):
        return out[i]
    return {k: v[i] for k, v in out.items()}


def _wait(out):
    """Block until the device has run the flush (the current stream of
    the first CUDA tensor of the output)."""
    vals = [out]
    while vals:
        v = vals.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                xfer.wait_stream(v)
                return
        elif isinstance(v, dict):
            vals.extend(v.values())
        elif isinstance(v, (list, tuple)):
            vals.extend(v)


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
            with stage("lockstep.stack.%s" % kname):
                fn = builder(key[1])
                lanes = [e[0] for e, *_ in pending]
            # more lanes than width (one group holding more streams):
            # runs of at most width lanes, one after another
            for lo in range(0, len(lanes), self.width):
                run = lanes[lo:lo + self.width]
                with stage("lockstep.dispatch.%s" % kname, lanes=len(run)):
                    out = fn(run)
                with stage("lockstep.run.%s" % kname):
                    if fetch:
                        _wait(out)
                if post is not None:
                    with stage("lockstep.post.%s" % kname):
                        out = post(out)
                for i, (e, *_) in enumerate(pending[lo:lo + self.width]):
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
