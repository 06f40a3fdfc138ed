"""blob.fallbacks_per_frame (planes/frame, layer ops): the port's counter
`blob.fallback` (a plane whose scan breaks the scan blob's contract,
counted in `parallel/batch` where the host takes it over) over the
window, per frame encoded. None where the port keeps no such counter or
no plane fell back."""


def read(obs):
    from dsv2_tpu_torch.utils import trace
    counters = getattr(trace, "counters", None)
    if counters is None or not obs["frames"]:
        return None
    n = counters().get("blob.fallback")
    return None if n is None else n / obs["frames"]
