"""lockstep.dispatch_ms (ms/flush, layer parallel): the span
`lockstep.dispatch.p_chain` (the lane-batched P chain step: its host
enqueue and the waits inside it) over the window, per p_chain flush."""


def read(obs):
    s = obs.get("spans", {}).get("lockstep.dispatch.p_chain")
    if not s or not s[1]:
        return None
    return 1e3 * s[0] / s[1]
