"""Chroma format down-conversions for decode output
(ref: src/util.c:78-153)."""
import numpy as np

from ..core import constants as K


def conv444to422(src):
    h, w = src.shape
    s = src.astype(np.uint16)
    idx = np.arange(0, w, 2)
    nxt = np.minimum(idx + 1, w - 1)
    return ((s[:, idx] + s[:, nxt] + 1) >> 1).astype(np.uint8)


def conv422to420(src):
    h, w = src.shape
    s = src.astype(np.uint16)
    idx = np.arange(0, h, 2)
    nxt = np.minimum(idx + 1, h - 1)
    return ((s[idx, :] + s[nxt, :] + 1) >> 1).astype(np.uint8)


def conv411to420(src):
    """Doubles width, halves height (ref: util.c:119-136)."""
    h, w = src.shape
    s = src.astype(np.uint16)
    out_w, out_h = w * 2, h // 2 + (h & 1)
    cols = np.arange(out_w) >> 1
    rows = np.arange(0, h, 2)
    nxt = np.minimum(rows + 1, h - 1)
    return (((s[rows][:, cols] + s[nxt][:, cols] + 1) >> 1)).astype(np.uint8)


def conv410to420(src):
    """Doubles both dims (ref: util.c:138-153)."""
    h, w = src.shape
    rows = np.arange(h * 2) >> 1
    cols = np.arange(w * 2) >> 1
    return src[rows][:, cols]


def to_420(planes, subsamp):
    y, u, v = planes
    if subsamp == K.SUBSAMP_444:
        u = conv422to420(conv444to422(u))
        v = conv422to420(conv444to422(v))
    elif subsamp in (K.SUBSAMP_422, K.SUBSAMP_UYVY):
        u, v = conv422to420(u), conv422to420(v)
    elif subsamp == K.SUBSAMP_411:
        u, v = conv411to420(u), conv411to420(v)
    elif subsamp == K.SUBSAMP_410:
        u, v = conv410to420(u), conv410to420(v)
    return [y, u, v]
