"""batch.host_ms (ms/frame, layer parallel): the host's own work in
`parallel/batch.encode_intra_batch`, the spans `batch.prep` and
`batch.serialize` summed over the window, per frame encoded."""


def read(obs):
    spans = obs.get("spans", {})
    parts = [spans[k][0] for k in ("batch.prep", "batch.serialize")
             if k in spans]
    if not parts or not obs["frames"]:
        return None
    return 1e3 * sum(parts) / obs["frames"]
