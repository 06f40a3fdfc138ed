"""hme_level_roofline (%, layer kernels): the share of its bytes
roofline that `hme_level` (kernel 4, the motion search's upper pyramid
levels) reaches in the profiled job: the least time its calls' bytes
(rooflines/hme_level.py) need at the card's memory rate (peaks.json)
over the device time of its launches."""
from codecbench.harness import roofline_share


def read(obs):
    return roofline_share(obs, "hme_level")
