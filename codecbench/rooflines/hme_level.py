"""Bytes of one upper pyramid level of the motion search (kernel 4,
csrc/hme_search.cu), counted from what the search needs, whatever
implements it.

A call searches level L (1 <= L <= levels) of one frame: the blocks of
the (nbv, nbh) grid at multiples of step = 2^L, ca x cb of them (ca =
ceil(nbh / step), cb = ceil(nbv / step)). It reads the level's source,
reference and original-grid luma planes, of which the search needs the
level's frame, fw x fh (the border repeats the frame's edges); at the
blocks it reads the parent field (fx, fy) of level L + 1, whose own
positions are those at multiples of 2 * step, ca' x cb' of them (none
at the top level, whose parent is zero), the previous frame's motion
field (tmv, where the frame has one: has_tmv) and the global motion (2
ints); it writes the level's field (fx, fy) at its ca x cb blocks. Every
field is int32. So the least traffic is:

    read   3 * fw * fh                        src, ref, ogr
         + 8 * ca' * cb'   (L < levels)        parent
         + 8 * ca * cb     (has_tmv)           tmv
         + 8                                   gxy
    write  8 * ca * cb                         out

Hand count at 64x48 in 16x16 blocks (nbh 4, nbv 3), level 1 of 3, with
tmv: fw x fh = 32 x 24, ca x cb = 2 x 2, ca' x cb' = 1 x 1: 2,304 + 8 +
32 + 8 + 32 = 2,384 bytes (codecbench/tests/test_codecbench_hme_rooflines.py).
"""
import re

# the launch wrapper whose calls are counted: _kernels.hme_level(src, ref,
# ogr, parent, tmv, gxy, out, sched, geom, workers=0)
TARGET = ("dsv2_tpu_torch.ops._kernels", "hme_level")
KERNEL = re.compile(r"\bhme_level_kernel\b")


def record(src, ref, ogr, parent, tmv, gxy, out, sched, geom, *args,
           **kwargs):
    """The call's geometry: its int32 parameter block by name."""
    from dsv2_tpu_torch.ops.hme_gpu import GEOM
    return {k: int(v) for k, v in zip(GEOM, geom)}


def _blocks(g, level):
    step = 1 << level
    return (-(-g["nbh"] // step)) * (-(-g["nbv"] // step))


def nbytes(g):
    level = g["level"]
    n = 3 * g["fw"] * g["fh"] + 8 + 8 * _blocks(g, level)
    if level < g["levels"]:
        n += 8 * _blocks(g, level + 1)
    if g["has_tmv"]:
        n += 8 * _blocks(g, level)
    return n
