"""device_wait_ms (ms/frame, layer codec): the host's waits for the card
on the job's critical path, per frame encoded: the `sync` spans of the
window (parallel/xfer's counted wait helper) that lie inside a
`lockstep.flush` span where the job runs in lockstep (every lane waits
for the flush), and every one where it does not (the intra batch runs in
one thread). Read from the port's trace records after the window; None
where the port keeps no records, or on a run with no card and no wait."""


def read(obs):
    from dsv2_tpu_torch.utils import trace
    records = getattr(trace, "records", None)
    if records is None or not obs["frames"]:
        return None
    recs = records()
    parent = {r.id: r.parent for r in recs}
    flushes = {r.id for r in recs if r.name == "lockstep.flush"}
    syncs = [r for r in recs if r.name == "sync"]
    if flushes:
        def under_flush(r):
            p = r.parent
            while p is not None:
                if p in flushes:
                    return True
                p = parent.get(p)
            return False
        syncs = [r for r in syncs if under_flush(r)]
    if not syncs and "busy_s" not in obs:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in syncs) / 1e9 / obs["frames"]
