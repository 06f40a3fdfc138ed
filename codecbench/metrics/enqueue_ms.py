"""enqueue_ms (ms/frame, layer parallel): the host's enqueue of the
batched device steps, per frame encoded: the self time of the spans
`batch.dispatch` (intra) and `lockstep.dispatch.<key>` (lockstep) over the
window, i.e. their time less that of their child spans, the counted
device waits `sync` among them. Read from the port's per-name span sums
(`utils/trace.table`) after the window; None where the port keeps no
self time."""


def read(obs):
    from dsv2_tpu_torch.utils import trace
    table = getattr(trace, "table", None)
    if table is None or not obs["frames"]:
        return None
    parts = [v[1] for k, v in table().items()
             if k == "batch.dispatch" or k.startswith("lockstep.dispatch.")]
    if not parts:
        return None
    return 1e3 * sum(parts) / obs["frames"]
