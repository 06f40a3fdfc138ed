"""device_idle.encode (%, layer device): the share of the profiled job's
wall time in which no kernel, copy or set ran on the card (the union of
the device intervals of the trace), in the cells that encode."""


def read(obs):
    if obs["kind"] != "encode" or "busy_s" not in obs:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["trace_window_s"])
