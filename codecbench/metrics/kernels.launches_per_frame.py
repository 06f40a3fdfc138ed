"""kernels.launches_per_frame (launches/frame, layer kernels): the
hand-written kernels' launches over the window, every `launch.*` counter
of the port (`launch.vk_chain`, `launch.wavefront_filter.<kind>`,
`launch.hme_<level kind>`), per frame encoded. None on a run with no card
(nothing launches there) or where the port keeps no counters."""


def read(obs):
    from dsv2_tpu_torch.utils import trace
    counters = getattr(trace, "counters", None)
    if counters is None or "busy_s" not in obs or not obs["frames"]:
        return None
    return sum(v for k, v in counters().items()
               if k.startswith("launch.")) / obs["frames"]
