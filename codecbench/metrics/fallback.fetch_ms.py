"""fallback.fetch_ms (ms/frame, layer parallel): the scan blob's host
fallback in `parallel/batch`, its fetches: the self time of the span
`batch.fallback.fetch` (a plane outside the blob contract, its int32
scan copied to the host alone) over the window, i.e. its time less that
of its child spans, the counted device wait `sync` among them, per frame
encoded. The blocking copy lies inside that `sync` (parallel/xfer.host),
behind whatever card work is queued ahead of it, so the wait and the
copy are read by `device_wait_ms` and this metric reads the host's own
work of the fetch. Read from the port's per-name span sums
(`utils/trace.table`) after the window; None where the port has no such
span, keeps no self time, or no plane fell back."""


def read(obs):
    from dsv2_tpu_torch.utils import trace
    table = getattr(trace, "table", None)
    if table is None or not obs["frames"]:
        return None
    span = table().get("batch.fallback.fetch")
    if span is None:
        return None
    return 1e3 * span[1] / obs["frames"]
