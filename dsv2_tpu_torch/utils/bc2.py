"""BC2 pseudo-perceptual integer color space (companion library).

Vectorized numpy port of the optional BC2 sRGB<->BC2 conversions that ship
alongside the reference codec (ref: bc2.c, bc2.h — not part of the codec
binary); the port's copy of `dsv2_tpu/utils/bc2.py`. B = brightness,
CS = chroma-significant (green-red), CI = chroma-insignificant
(blue-yellow); gamma approximated by square/sqrt.
All tables and arithmetic match the reference exactly.
"""
import numpy as np

NREV = 2560 * 4 - 1
_tables = None


def _isqrt(n):
    n = np.asarray(n, dtype=np.uint64)
    r = np.floor(np.sqrt(n.astype(np.float64))).astype(np.uint64)
    r = np.where((r + 1) * (r + 1) <= n, r + 1, r)
    r = np.where(r * r > n, r - 1, r)
    return r


def _divceil(x, y):
    # C truncating division of (possibly negative) x with positive y
    q = np.abs(x + y - 1) // y
    return np.where((x + y - 1) < 0, -q, q)


def _init():
    global _tables
    if _tables is not None:
        return _tables
    i = np.arange(256 * 256, dtype=np.int64)
    sqrttab = ((_isqrt(i * 64) + 1) // 2).astype(np.int64)
    j = np.arange(256, dtype=np.int64)
    sqrndtab = (j * j + _isqrt(j)).astype(np.int64)
    expand = _divceil(8 * (j - 16) * 255, 219).astype(np.int64)
    k = np.arange(NREV + 1, dtype=np.int64)
    rev = _divceil(_isqrt(k << 17).astype(np.int64) * 29309, 1 << 22)
    revmap = np.clip(rev, 0, 255).astype(np.uint8)
    _tables = (sqrttab, sqrndtab, expand, revmap)
    return _tables


def srgb_to_bc2(r, g, b, full_range=True):
    """Vectorized SRGB_TO_BC2 (ref: bc2.h:76-98)."""
    sqrttab, sqrndtab, _, _ = _init()
    r = np.asarray(r, dtype=np.int64)
    g = np.asarray(g, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    fr = sqrndtab[r]
    fg = sqrndtab[g]
    fb = sqrndtab[b] * 20
    tb = sqrttab[(81 * fr + 139 * fg + fb) // 240]
    ts = sqrttab[(51 * fr + 169 * fg + fb) // 240]
    ti = sqrttab[(11 * fr + 9 * fg + fb) // 40]
    fr = (tb + ts) // 8
    fg = ts - tb
    fb = ti // 4 - fr
    br = np.clip(fr, 0, 255)
    if not full_range:
        br = (br * 219) // 255 + 16
    cs = np.clip(fg + 128, 0, 255).astype(np.uint8)
    ci = np.clip(fb + 128, 0, 255).astype(np.uint8)
    return br.astype(np.uint8), cs, ci


def bc2_to_srgb(br, cs, ci, full_range=True):
    """Vectorized BC2_TO_SRGB (ref: bc2.h:101-122)."""
    _, _, expand, revmap = _init()
    br = np.asarray(br, dtype=np.int64)
    cs = np.asarray(cs, dtype=np.int64)
    ci = np.asarray(ci, dtype=np.int64)
    fr = br * 8 if full_range else expand[br]
    fg = cs - 128
    fb = (ci - 128) * 8
    tb = fr - fg
    ts = fr + fg
    ti = fr + fb
    tb = tb * tb
    ts = ts * ts
    ti = ti * ti

    def divt(x, d):
        q = np.abs(x) // d
        return np.where(x < 0, -q, q)

    r = divt(32 * tb - 26 * ts - ti, 2048)
    g = divt(-8 * tb + 14 * ts - ti, 2048)
    b = divt(-14 * tb + 8 * ts + 11 * ti, 2048)
    r = revmap[np.clip(r, 0, NREV)]
    g = revmap[np.clip(g, 0, NREV)]
    b = revmap[np.clip(b, 0, NREV)]
    return r, g, b
