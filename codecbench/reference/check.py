"""The benchmark's judgement of what a timed job produced, against the
plain reference: the conformance decoder beside this file (numpy only).

Nothing here imports the codec under test or takes anything it made
other than the outputs being judged: the source frames come from the
clip generator and every decoded picture from `d28dec`.

- `encode_faults` judges an encoded stream: its packet structure, and
  the pictures it is given the source frames of, each decoded by the
  reference (every plane's parse ends exactly at its length, frame
  number, picture size), with the luma MSE of each against its source
  frame. The quantizer is not checked: at the CLI's default rate control
  (CRF) `-qp` sets a quality that the rate controller turns into a
  quantizer per picture. Nor are the bytes compared with another
  encoder's: no independent encoder is here.
- `parallel` runs independent decodes (lanes, groups of intra pictures)
  in fresh processes, one per core at most.
"""
import multiprocessing
import os
import struct
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import d28dec

HDR_SIZE, NEXT_OFF = 14, 10
FOURCC = b"DSV2"
PT_META, PT_PIC, PT_EOS = 0x00, 0x04, 0x10
# y4m chroma tag -> the stream's subsampling code (ref: src/dsv.h)
SUBSAMP = {"444": 0x0, "422": 0x4, "420": 0x5, "411": 0x8, "410": 0xA}
MSE_NONE = 255.0 ** 2   # the luma MSE reported when no picture decodes


def packets(stream):
    """[(type, buf), ...] of a byte stream, walked by each header's link
    to the next packet, and the number of bytes left that no packet
    holds (0 for a sound stream)."""
    out, pos, n = [], 0, len(stream)
    while pos + HDR_SIZE <= n and stream[pos:pos + 4] == FOURCC:
        size = struct.unpack_from(">I", stream, pos + NEXT_OFF)[0]
        size = HDR_SIZE if size == 0 else size
        if size < HDR_SIZE or pos + size > n:
            break
        out.append((stream[pos + 5], bytes(stream[pos:pos + size])))
        pos += size
    return out, n - pos


def _fno(buf):
    r = d28dec.Bits(buf, HDR_SIZE * 8)
    r.align()
    return r.bits(32)


def encode_faults(stream, src, nframes, cfg, gop, eos, structure=True):
    """(faults, mse_y) of one encoded stream of `nframes` frames at
    -gop=`gop` under configuration `cfg`; `src` maps picture indices to
    their source frames' (y, u, v) planes.

    faults counts what is wrong. With `structure`: bytes that no packet
    holds; a packet that is not where the stream's structure puts it (a
    metadata packet first, an intra picture after each metadata packet
    and every picture intra at -gop=0, one picture per frame numbered in
    order, an end-of-stream packet last where `eos`; the encoder may
    open a GOP early, on an intra picture, so the GOP length is not
    checked). For each picture index in `src`, decoded with the pictures
    from the intra picture before it: a picture missing or one the
    decoder rejects, a plane whose payload fails the decoder's guards or
    whose parse does not end at its length, a frame number or picture
    size other than the stream's and the configuration's. mse_y lists
    the luma MSE of each picture in `src` against its source frame."""
    faults = 0
    pkts, rest = packets(stream)
    if eos:
        if pkts and pkts[-1][0] == PT_EOS:
            pkts = pkts[:-1]
        else:
            faults += structure
    pics = []           # (index of the last metadata packet, type, buf)
    last_meta = None
    for i, (t, buf) in enumerate(pkts):
        if t == PT_META:
            last_meta = i
        elif t & PT_PIC and not t & PT_EOS:
            pics.append((last_meta, t, buf))
        else:
            faults += structure
    if structure:
        faults += rest != 0
        faults += abs(len(pics) - nframes)
        faults += not pkts or pkts[0][0] != PT_META
        for k, (meta_i, t, buf) in enumerate(pics):
            faults += _fno(buf) != k
            new_meta = k == 0 or pics[k - 1][0] != meta_i
            if (gop <= 0 or new_meta) and t & 1:
                faults += 1      # metadata opens a GOP on an intra picture
    mses = []
    need = sorted(k for k in src if k < len(pics))
    faults += len(src) - len(need)
    runs = {}            # intra picture -> the pictures it leads to
    for k in need:
        first = k
        while first > 0 and pics[first][1] & 1:
            first -= 1
        runs.setdefault(first, []).append(k)
    for first, ks in sorted(runs.items()):
        meta_i = pics[first][0]
        if meta_i is None:
            faults += 1
            continue
        dec = d28dec.ConformanceDecoder()
        dec.decode_packet(pkts[meta_i][1])
        m = dec.meta or {}
        faults += (m.get("width"), m.get("height"), m.get("subsamp")) != (
            cfg["width"], cfg["height"], SUBSAMP[cfg["subsamp"]])
        for j in range(first, ks[-1] + 1):
            try:
                kind, vis, fno = dec.decode_packet(pics[j][2])
            except (d28dec.CorruptStream, IndexError, ValueError,
                    KeyError):
                kind = "err"
            if kind != "pic":
                faults += 1
                break
            faults += fno != j
            if j not in src:
                continue
            if any(p.shape != q.shape for p, q in zip(vis, src[j])):
                faults += 1
                continue
            d = vis[0].astype(np.float64) - src[j][0]
            mses.append(float(np.mean(d * d)))
        faults += dec.plane_faults
    return faults, mses


def split(indices, parts=None):
    """`indices` in at most `parts` (the workers `parallel` runs)
    contiguous groups of near-equal size."""
    idx = list(indices)
    parts = min(parts or workers(), len(idx)) or 1
    return [g for g in (idx[len(idx) * i // parts:len(idx) * (i + 1) // parts]
                        for i in range(parts)) if g]


def workers():
    return min(os.cpu_count() or 1, 8)


def _call(fn_args):
    fn, args = fn_args
    return fn(*args)


def parallel(fn, arglists):
    """[fn(*args) for args in arglists], each in a fresh process (spawned:
    nothing of the caller's process but these arguments reaches it)."""
    if not arglists:
        return []
    n = min(len(arglists), workers())
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=n, mp_context=ctx) as ex:
        return list(ex.map(_call, [(fn, a) for a in arglists]))
