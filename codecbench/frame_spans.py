"""A single stream's frame time, split from the port's trace records:
what the metrics `encode.dispatch_ms` and `encode.host_ms` read.

Inside the `encode_frame` spans (codec/encoder), every second is in one
of three parts:

- dispatch: the spans `encode.dispatch.<key>` (the one-frame device
  steps' calls outside lockstep: input_prep, i_chain, p_chain, and the
  motion search's hme), less the `sync` spans inside them;
- sync: the `sync` spans (parallel/xfer's counted waits for the card),
  inside a dispatch span or not;
- host: the rest: rate control, scene change detection, the mode and
  motion coding, the serializers and the uploads.
"""

PREFIX = "encode.dispatch."


def split(recs):
    """{"frame", "dispatch", "sync", "host"}: seconds of each part over
    the closed spans `recs` (trace.records()), or None where no
    `encode.dispatch.*` span is among them (a lockstep or intra batch
    job, or a port without these spans)."""
    byid = {r.id: r for r in recs}

    def under(r, name_ok):
        p = r.parent
        while p is not None and p in byid:
            q = byid[p]
            if name_ok(q.name):
                return True
            p = q.parent
        return False

    def is_frame(name):
        return name == "encode_frame"

    def is_dispatch(name):
        return name.startswith(PREFIX)

    ns = dict(frame=0, dispatch=0, sync=0)
    seen = False
    for r in recs:
        d = r.t1 - r.t0
        if is_frame(r.name):
            ns["frame"] += d
        elif is_dispatch(r.name):
            seen = True
            if under(r, is_frame):
                ns["dispatch"] += d
        elif r.name == "sync" and under(r, is_frame):
            ns["sync"] += d
            if under(r, is_dispatch):
                ns["dispatch"] -= d
    if not seen:
        return None
    out = {k: v / 1e9 for k, v in ns.items()}
    out["host"] = out["frame"] - out["dispatch"] - out["sync"]
    return out


def per_frame_ms(obs, part):
    """`part` of the window's frames in ms per frame encoded, read from
    the port's trace records; None where it keeps none or `split` finds
    no dispatch span."""
    from dsv2_tpu_torch.utils import trace
    records = getattr(trace, "records", None)
    if records is None or not obs["frames"]:
        return None
    parts = split(records())
    if parts is None:
        return None
    return 1e3 * parts[part] / obs["frames"]
