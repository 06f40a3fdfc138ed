"""Frame/plane containers and border handling (host, numpy).

The codec reads outside the visible frame in several places (motion
compensation with out-of-frame vectors, the forward transform's extra
coefficient column/row for odd chroma dims), so reference frames carry a
32-pixel apron filled with 4:1 downsampled edge strips exactly like the
reference (ref: src/frame.c:250-434).
"""
from typing import List

import numpy as np

from . import constants as K
from . import intmath as im

B = K.FRAME_BORDER
SUBDIV = 4


def plane_dims(subsamp, w, h):
    """Visible plane dims per component (ref: src/frame.c:80-83)."""
    cw = im.round_shift(w, K.fmt_h_shift(subsamp))
    ch = im.round_shift(h, K.fmt_v_shift(subsamp))
    return [(w, h), (cw, ch), (cw, ch)]


def coef_dims(subsamp, w, h):
    """Coefficient plane dims (chroma rounded to even; ref: src/frame.c:29-60)."""
    cw = im.round_pow2(im.round_shift(w, K.fmt_h_shift(subsamp)), 1)
    ch = im.round_pow2(im.round_shift(h, K.fmt_v_shift(subsamp)), 1)
    return [(w, h), (cw, ch), (cw, ch)]


class Frame:
    """Planar 8-bit frame; each plane is stored inside a bordered array."""

    __slots__ = ("subsamp", "width", "height", "border", "planes")

    def __init__(self, subsamp, width, height, border=True):
        self.subsamp = subsamp
        self.width = width
        self.height = height
        self.border = border
        b = B if border else 0
        self.planes: List[np.ndarray] = [
            np.zeros((h + 2 * b, w + 2 * b), dtype=np.uint8)
            for (w, h) in plane_dims(subsamp, width, height)
        ]

    @property
    def b(self):
        return B if self.border else 0

    def view(self, c):
        """Visible region of plane c."""
        b = self.b
        p = self.planes[c]
        return p[b:p.shape[0] - b, b:p.shape[1] - b]

    def dims(self, c):
        v = self.view(c)
        return v.shape[1], v.shape[0]

    def load(self, planes):
        for c, src in enumerate(planes):
            self.view(c)[:, :] = src
        return self

    def copy_from(self, other):
        for c in range(3):
            self.view(c)[:, :] = other.view(c)
        if self.border:
            self.extend()
        return self

    def clone(self, border=True):
        f = Frame(self.subsamp, self.width, self.height, border)
        for c in range(3):
            f.view(c)[:, :] = self.view(c)
        if border:
            f.extend()
        return f

    def extend(self, luma_only=False):
        for c in range(1 if luma_only else 3):
            _extend_plane(self.planes[c], *_vis(self, c))
        return self

    def tobytes(self):
        return b"".join(self.view(c).tobytes() for c in range(3))


def _vis(frame, c):
    v = frame.view(c)
    return v.shape[1], v.shape[0]  # w, h


def _strip(vals):
    """4:1 box downsample of a 1-D edge with remainder averaging
    (ref: src/frame.c:250-355)."""
    v = vals.astype(np.int32)
    n = v.shape[0]
    ln = n & ~(SUBDIV - 1)
    rem = n & (SUBDIV - 1)
    main = (v[:ln].reshape(-1, SUBDIV).sum(axis=1) + 2) >> 2
    if rem:
        tail = v[ln:].sum() // rem
        main = np.concatenate([main, [tail]])
    return main.astype(np.uint8)


def _extend_plane(arr, w, h):
    """Fill the 32-px apron (ref: src/frame.c:357-410)."""
    vis = arr[B:B + h, B:B + w]
    ls = _strip(vis[:, 0])
    rs = _strip(vis[:, w - 1])
    ts = _strip(vis[0, :])
    bs = _strip(vis[h - 1, :])
    def cval(strip, dim):
        """Strip entry (dim//SUBDIV - 1) for the corner average. For
        dim < SUBDIV the reference indexes one byte BEFORE the strip,
        which its instrumented allocator guarantees is 0 (the calloc'd
        header padding; ref: frame.c:377-380, dsv.c:49-64) — reachable
        on ME-pyramid levels of small frames (e.g. 32x16 -> 4x2 at L3)."""
        i = (dim // SUBDIV) - 1
        return int(strip[i]) if i >= 0 else 0

    tl = (int(ts[0]) + int(ls[0]) + 1) >> 1
    tr = (cval(ts, w) + int(rs[0]) + 1) >> 1
    bl = (cval(ls, h) + int(bs[0]) + 1) >> 1
    br = (cval(bs, w) + cval(rs, h) + 1) >> 1

    ridx = np.arange(h) // SUBDIV
    arr[B:B + h, :B] = ls[ridx][:, None]
    arr[B:B + h, B + w:] = rs[ridx][:, None]
    cidx = np.arange(w) // SUBDIV
    arr[:B, :B] = tl
    arr[:B, B:B + w] = ts[cidx][None, :]
    arr[:B, B + w:] = tr
    arr[B + h:, :B] = bl
    arr[B + h:, B:B + w] = bs[cidx][None, :]
    arr[B + h:, B + w:] = br


def ds2x_luma(dst: Frame, src: Frame):
    """2x luma downsample for the ME pyramid; reads src's border for odd
    dims (ref: src/frame.c:210-234)."""
    dv = dst.view(0)
    dh, dw = dv.shape
    sb = src.b
    sp = src.planes[0]
    win = sp[sb:sb + 2 * dh + 1, sb:sb + 2 * dw + 1].astype(np.uint16)
    p1 = win[0:2 * dh:2, 0:2 * dw:2]
    p2 = win[0:2 * dh:2, 1:2 * dw + 1:2]
    p3 = win[1:2 * dh + 1:2, 0:2 * dw:2]
    p4 = win[1:2 * dh + 1:2, 1:2 * dw + 1:2]
    dv[:, :] = ((p1 + p2 + p3 + p4 + 2) >> 2).astype(np.uint8)
    return dst
