"""host_syncs_per_frame (waits/frame, layer codec): the port's counter
`sync` (every host-device wait, through parallel/xfer's counted helper)
over the window, per frame encoded. None on a run with no card (nothing
waits there) or where the port keeps no counters."""


def read(obs):
    from dsv2_tpu_torch.utils import trace
    counters = getattr(trace, "counters", None)
    if counters is None or "busy_s" not in obs or not obs["frames"]:
        return None
    return counters().get("sync", 0) / obs["frames"]
