"""ops.scatter_add_ms (ms/frame, layer ops): the device time of the
kernels launched under `aten::scatter_add_` (the scan blob's emission
in the batched intra step) in the profiled job, per frame."""


def read(obs):
    v = obs.get("op_s", {}).get("aten::scatter_add_")
    if not v or not obs.get("profiled_frames"):
        return None
    return 1e3 * v / obs["profiled_frames"]
