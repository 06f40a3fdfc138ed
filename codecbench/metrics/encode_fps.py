"""encode_fps (frames/s, host clock): every frame encoded to a finished
packet in the window over the window's length. The window runs from the
first job's start to the end of the job that crosses `--seconds`."""


def read(obs):
    if obs["kind"] != "encode":
        return None
    return obs["frames"] / obs["window_s"]
