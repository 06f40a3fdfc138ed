"""lockstep.gather_ms (ms/frame, layer parallel): the span
`lockstep.gather` (the lockstep batcher waiting for its last lane to
block, from the end of its previous flush) over the window, per frame
encoded. With the `lockstep.flush` seconds it tiles a lockstep job's wall
time: every lane blocks until the flush."""


def read(obs):
    s = obs.get("spans", {}).get("lockstep.gather")
    if not s or not obs["frames"]:
        return None
    return 1e3 * s[0] / obs["frames"]
