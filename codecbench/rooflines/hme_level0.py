"""Bytes of the base level of the motion search (kernel 5,
csrc/hme_search.cu), counted from what the search needs, whatever
implements it.

A call searches every block of the (nbv, nbh) grid of one frame, nb =
nbv * nbh of them, and decides its mode. It reads the frame's source,
reference and original-grid luma planes, of which the search needs the
frame, fw x fh (the border repeats the frame's edges), and the source's
and reference's chroma planes, cw x ch each (cw = ceil(fw / 2^hs), ch =
ceil(fh / 2^vs)); at the blocks it reads the parent field (fx, fy) of
level 1, whose own positions are those at even block coordinates, ca' x
cb' of them, the previous frame's motion field (tmv, where the frame has
one: has_tmv) and the global motion (2 ints); it writes the 7 int32
fields (fx, fy, flags, err, dc, submask, fskip) of every block and the
4 int32 frame sums. So the least traffic is:

    read   3 * fw * fh + 4 * cw * ch          luma src, ref, ogr; chroma
         + 8 * ca' * cb'                       parent
         + 8 * nb          (has_tmv)           tmv
         + 8                                   gxy
    write  28 * nb + 16                        out, sums

Hand count at 64x48 4:2:0 in 16x16 blocks (nbh 4, nbv 3), with tmv:
fw x fh = 64 x 48, cw x ch = 32 x 24, ca' x cb' = 2 x 2: 9,216 + 3,072
+ 32 + 96 + 8 + 336 + 16 = 12,776 bytes
(codecbench/tests/test_codecbench_hme_rooflines.py).
"""
import re

# the launch wrapper whose calls are counted: _kernels.hme_level0(src,
# ref, ogr, chroma, parent, tmv, gxy, out, sums, sched, geom)
TARGET = ("dsv2_tpu_torch.ops._kernels", "hme_level0")
KERNEL = re.compile(r"\bhme_level0_kernel\b")


def record(src, ref, ogr, chroma, parent, tmv, gxy, out, sums, sched,
           geom, *args, **kwargs):
    """The call's geometry: its int32 parameter block by name."""
    from dsv2_tpu_torch.ops.hme_gpu import GEOM
    return {k: int(v) for k, v in zip(GEOM, geom)}


def nbytes(g):
    nb = g["nbh"] * g["nbv"]
    fw, fh = g["fw"], g["fh"]
    cw = -(-fw >> g["hs"])
    ch = -(-fh >> g["vs"])
    parent = (-(-g["nbh"] // 2)) * (-(-g["nbv"] // 2))
    n = 3 * fw * fh + 4 * cw * ch + 8 * parent + 8 + 28 * nb + 16
    if g["has_tmv"]:
        n += 8 * nb
    return n
