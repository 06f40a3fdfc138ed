"""fallback.code_ms (ms/frame, layer codec): the scan blob's host
fallback in `parallel/batch`, its coding: the span `batch.fallback.code`
(a fetched int32 scan coded on the host by `codec/plane.encode_plane`)
over the window, per frame encoded. None where the port has no such span
or no plane fell back."""


def read(obs):
    span = obs.get("spans", {}).get("batch.fallback.code")
    if span is None or not obs["frames"]:
        return None
    return 1e3 * span[0] / obs["frames"]
