"""vk_chain_roofline (%, layer kernels): the share of its bytes roofline
that `vk_chain` reaches in the profiled job: the least time its calls'
bytes (rooflines/vk_chain.py) need at the card's memory rate (peaks.json)
over the device time of its launches."""
from codecbench.harness import roofline_share


def read(obs):
    return roofline_share(obs, "vk_chain")
