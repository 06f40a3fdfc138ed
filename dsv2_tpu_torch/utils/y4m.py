"""Y4M / raw YUV file I/O (ref: src/util.c:155-488, src/dsv.c:109-305)."""
import numpy as np

from ..core import constants as K
from ..core import intmath as im


def frame_size(w, h, subsamp):
    npix = w * h
    if subsamp == K.SUBSAMP_444:
        return npix * 3
    if subsamp in (K.SUBSAMP_422, K.SUBSAMP_UYVY):
        return npix * 2
    if subsamp in (K.SUBSAMP_420, K.SUBSAMP_411):
        return npix * 3 // 2
    if subsamp == K.SUBSAMP_410:
        return npix * 9 // 8
    raise ValueError("unsupported subsampling 0x%x" % subsamp)


def split_planes(raw, w, h, subsamp):
    """Raw planar frame bytes -> (y, u, v) uint8 arrays."""
    if subsamp == K.SUBSAMP_UYVY:
        buf = np.frombuffer(raw, dtype=np.uint8).reshape(h, w * 2)
        u = buf[:, 0::4]
        y = np.empty((h, w), np.uint8)
        y[:, 0::2] = buf[:, 1::4]
        y[:, 1::2] = buf[:, 3::4]
        v = buf[:, 2::4]
        return y, np.ascontiguousarray(u), np.ascontiguousarray(v)
    hs, vs = K.fmt_h_shift(subsamp), K.fmt_v_shift(subsamp)
    cw, ch = im.round_shift(w, hs), im.round_shift(h, vs)
    a = np.frombuffer(raw, dtype=np.uint8)
    y = a[:w * h].reshape(h, w)
    u = a[w * h:w * h + cw * ch].reshape(ch, cw)
    v = a[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)
    return y, u, v


class Y4MReader:
    def __init__(self, f):
        self.f = f
        self.w = self.h = 0
        self.subsamp = K.SUBSAMP_420
        self.fps = (30, 1)
        self.aspect = (1, 1)
        self._parse_header()
        try:
            self._data_start = f.tell()
        except (OSError, ValueError):
            self._data_start = None

    def _parse_header(self):
        magic = self.f.read(10)
        if magic != b"YUV4MPEG2 ":
            raise ValueError("bad Y4M header")
        line = b""
        while not line.endswith(b"\n"):
            c = self.f.read(1)
            if not c:
                raise ValueError("early EOF in Y4M header")
            line += c
        for tok in line[:-1].split(b" "):
            if not tok:
                continue
            key, val = tok[:1], tok[1:]
            if key == b"W":
                self.w = int(val)
            elif key == b"H":
                self.h = int(val)
            elif key == b"F":
                n, d = val.split(b":")
                self.fps = (int(n), int(d))
            elif key == b"A":
                n, d = val.split(b":")
                self.aspect = (int(n), int(d))
            elif key == b"C":
                s = val[:3]
                self.subsamp = {
                    b"420": K.SUBSAMP_420, b"411": K.SUBSAMP_411,
                    b"410": K.SUBSAMP_410, b"422": K.SUBSAMP_422,
                    b"444": K.SUBSAMP_444}.get(s, K.SUBSAMP_420)

    def read_frame(self):
        hdr = self.f.read(6)
        if len(hdr) < 6:
            return None
        if hdr != b"FRAME\n":
            raise ValueError("bad Y4M frame header")
        raw = self.f.read(frame_size(self.w, self.h, self.subsamp))
        if len(raw) < frame_size(self.w, self.h, self.subsamp):
            return None
        return split_planes(raw, self.w, self.h, self.subsamp)

    def seek_to_frame(self, fno):
        """Position at frame fno by direct seek (ref: util.c:312-391);
        read+skip fallback on unseekable input (pipes)."""
        fsz = 6 + frame_size(self.w, self.h, self.subsamp)
        try:
            self.f.seek(self._data_start + fno * fsz)
        except (OSError, ValueError, AttributeError, TypeError):
            for _ in range(fno):
                if self.read_frame() is None:
                    break


class RawYUVReader:
    def __init__(self, f, w, h, subsamp):
        self.f = f
        self.w, self.h, self.subsamp = w, h, subsamp

    def _frame_bytes(self):
        if self.subsamp == K.SUBSAMP_UYVY:
            return self.w * self.h * 2
        return frame_size(self.w, self.h, self.subsamp)

    def read_frame(self):
        n = self._frame_bytes()
        raw = self.f.read(n)
        if len(raw) < n:
            return None
        return split_planes(raw, self.w, self.h, self.subsamp)

    def seek_to_frame(self, fno):
        """Position at frame fno by direct seek (ref: dsv.c:109-160);
        read+skip fallback on unseekable input (pipes)."""
        try:
            self.f.seek(fno * self._frame_bytes())
        except (OSError, ValueError, AttributeError):
            for _ in range(fno):
                if self.read_frame() is None:
                    break


def y4m_subs_name(subsamp):
    return {K.SUBSAMP_444: b"444", K.SUBSAMP_422: b"422",
            K.SUBSAMP_UYVY: b"422", K.SUBSAMP_420: b"420",
            K.SUBSAMP_411: b"411", K.SUBSAMP_410: b"410"}[subsamp]


class Y4MWriter:
    def __init__(self, f, w, h, subsamp, fps=(30, 1), aspect=(1, 1)):
        self.f = f
        self.first = True
        self.hdr = (b"YUV4MPEG2 W%d H%d F%d:%d A%d:%d Ip C%s\n"
                    % (w, h, fps[0], fps[1], aspect[0], aspect[1],
                       y4m_subs_name(subsamp)))

    def write_frame(self, planes):
        if self.first:
            self.f.write(self.hdr)
            self.first = False
        self.f.write(b"FRAME\n")
        for p in planes:
            self.f.write(np.ascontiguousarray(p).tobytes())


class RawYUVWriter:
    def __init__(self, f):
        self.f = f

    def write_frame(self, planes):
        for p in planes:
            self.f.write(np.ascontiguousarray(p).tobytes())
