"""setup_s (s, host clock): process start to the first timed job: the
port's kernels built or loaded, the seeded clip made (and, where the
cell needs it, its input encoded), one warm job."""


def read(obs):
    return obs["setup_s"]
