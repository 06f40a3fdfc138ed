"""Motion-vector prediction and neighborhood metrics (host, per-block).

Used by both the motion-field deserializer (decoder) and the serializer /
cost model (encoder). (ref: src/dsv.c:324-447)
"""
import numpy as np

from . import constants as K


def pred3(left, top, topleft):
    dif = left + top - topleft
    if abs(dif - left) < abs(dif - top):
        return left
    return top


def movec_pred(mvx, mvy, nbh, x, y):
    """Median-style predictor from left/top/topleft (ref: dsv.c:373-400)."""
    vx = [0, 0, 0]
    vy = [0, 0, 0]
    if x > 0:
        k = (x - 1) + y * nbh
        vx[0], vy[0] = mvx[k], mvy[k]
    if y > 0:
        k = x + (y - 1) * nbh
        vx[1], vy[1] = mvx[k], mvy[k]
    if x > 0 and y > 0:
        k = (x - 1) + (y - 1) * nbh
        vx[2], vy[2] = mvx[k], mvy[k]
    return pred3(vx[0], vx[1], vx[2]), pred3(vy[0], vy[1], vy[2])


def neighbordif2(mvx, mvy, skip, nbh, x, y):
    """|mv - left|, |mv - top| similarity metric (ref: dsv.c:402-438)."""
    k = x + y * nbh
    cmx, cmy = int(mvx[k]), int(mvy[k])
    if abs(cmx) < 2 and abs(cmy) < 2:
        return 0, 0
    vx0, vy0 = cmx, cmy
    vx1, vy1 = cmx, cmy
    if x > 0:
        k2 = (x - 1) + y * nbh
        if (mvx[k2] or mvy[k2]) and not skip[k2]:
            vx0, vy0 = int(mvx[k2]), int(mvy[k2])
    if y > 0:
        k2 = x + (y - 1) * nbh
        if (mvx[k2] or mvy[k2]) and not skip[k2]:
            vx1, vy1 = int(mvx[k2]), int(mvy[k2])
    return abs(vx0 - cmx) + abs(vy0 - cmy), abs(vx1 - cmx) + abs(vy1 - cmy)


def neighbordif(mvx, mvy, skip, nbh, x, y):
    d0, d1 = neighbordif2(mvx, mvy, skip, nbh, x, y)
    return (d0 + d1) // 3


def seg_bits(v):
    """Bit cost of a SEG code (ref: dsv.c:334-354)."""
    v = int(v)
    if v < 0:
        v = -v
    v += 1
    n_bits = v.bit_length() - 1
    ln = n_bits * 2 + 1
    return ln + 1  # v >= 1 always after the increment


def _w32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def mv_cost(mvx, mvy, nbh, blk_w, blk_h, vid_w, vid_h, i, j, mx, my, q, sqr):
    """Approximate R/D cost of coding (mx,my) at block (i,j); int32
    wraparound matches the reference's C ints (ref: dsv.c:356-371)."""
    px, py = movec_pred(mvx, mvy, nbh, i, j)
    bits = seg_bits(mx - px) + seg_bits(my - py)
    b2sr = (256 * ((q * q) >> K.MAX_QP_BITS) * blk_w * blk_h) // (vid_w * vid_h)
    bits = _w32(bits + (_w32(bits * b2sr) >> 7))
    if sqr:
        bits = _w32(bits * bits)
    return bits


def seg_bits_grid(v):
    """Vectorized seg_bits (ref: dsv.c:334-354)."""
    a = np.abs(v.astype(np.int64)) + 1
    nb = np.frexp(a.astype(np.float64))[1] - 1  # exact bit_length - 1
    return nb * 2 + 2


def movec_pred_grid(xg, yg):
    """Vectorized median predictor over the whole (final) field."""
    def shifted(a, dx, dy):
        out = np.zeros_like(a)
        if dx and dy:
            out[1:, 1:] = a[:-1, :-1]
        elif dx:
            out[:, 1:] = a[:, :-1]
        else:
            out[1:, :] = a[:-1, :]
        return out

    def p3(left, top, topleft):
        dif = left + top - topleft
        return np.where(np.abs(dif - left) < np.abs(dif - top), left, top)

    px = p3(shifted(xg, 1, 0), shifted(xg, 0, 1), shifted(xg, 1, 1))
    py = p3(shifted(yg, 1, 0), shifted(yg, 0, 1), shifted(yg, 1, 1))
    return px, py


def mv_cost_grid(xg, yg, blk_w, blk_h, vid_w, vid_h, q, sqr):
    """Vectorized mv_cost of each block's own vector against its median
    prediction (int32 wrap like the C ints)."""
    def w32(x):
        x = np.asarray(x, dtype=np.int64)
        return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000

    px, py = movec_pred_grid(xg.astype(np.int64), yg.astype(np.int64))
    bits = seg_bits_grid(xg.astype(np.int64) - px) +         seg_bits_grid(yg.astype(np.int64) - py)
    b2sr = (256 * ((q * q) >> K.MAX_QP_BITS) * blk_w * blk_h) // (vid_w * vid_h)
    bits = w32(bits + (w32(bits * b2sr) >> 7))
    if sqr:
        bits = w32(bits * bits)
    return bits
