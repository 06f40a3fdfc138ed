"""Decoder debug overlay: block grid, stability/skip markers, motion-vector
rays (Bresenham), intra sub-block dots (ref: src/dsv_decoder.c:240-350)."""
import numpy as np

from ..core import constants as K

DRAW_STABHQ = 1
DRAW_MOVECS = 2
DRAW_IBLOCK = 4
SHADE = 255


def _drawvec(lp, x0, y0, x1, y1, bw, bh):
    h, w = lp.shape
    x0 = x0 + bw // 2
    y0 = y0 + bh // 2
    x1 += x0
    y1 += y0
    dx = abs(x1 - x0)
    dy = abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    if 0 <= y0 < h and 0 <= x0 < w:
        lp[y0, x0] = SHADE
    while x0 != x1 or y0 != y1:
        if 0 <= y0 < h and 0 <= x0 < w:
            lp[y0, x0] = SHADE
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy


def draw_info(luma, blockdata, mf, params, mode, isP):
    """Mutates the luma plane view (h, w) in place."""
    lp = luma
    h, w = lp.shape
    bw, bh = params.blk_w, params.blk_h
    nbh, nbv = params.nbh, params.nbv
    for j in range(nbv):
        y = j * bh
        lp[y, :] = SHADE
        for i in range(nbh):
            x = i * bw
            if x < w:
                lp[y:min(y + bh, h), x] = SHADE
            idx = i + j * nbh
            if mode & DRAW_STABHQ:
                a, b = x + bw // 2, y + bh // 2
                if blockdata[idx] & (K.IS_SKIP | K.IS_STABLE):
                    for k in range(-bw // 4, bw // 4 + 1):
                        if 0 <= b < h and 0 <= a + k < w:
                            lp[b, a + k] = (k & 1) * 255
                if blockdata[idx] & K.IS_MAINTAIN:
                    for k in range(-bh // 4, bh // 4 + 1):
                        if 0 <= b + k < h and 0 <= a < w:
                            lp[b + k, a] = (k & 1) * 255
            if mf is not None and isP:
                if (mode & DRAW_MOVECS) and not (blockdata[idx] & K.IS_SKIP):
                    _drawvec(lp, x, y, int(mf.x[idx]), int(mf.y[idx]), bw, bh)
                if mode & DRAW_IBLOCK:
                    sm = int(mf.submask[idx])
                    for bit, (fx, fy) in enumerate(((1, 1), (3, 1),
                                                    (1, 3), (3, 3))):
                        if sm & (1 << bit):
                            a = x + bw * fx // 4
                            b = y + bh * fy // 4
                            if 0 <= b < h and 0 <= a < w:
                                lp[b, a] = SHADE
