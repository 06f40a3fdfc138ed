"""The judgement of a lossless stream: every sample of every plane of
every picture decoded equal to its source frame's.

Numpy and the standard library only, beside `check.py` and the frozen
conformance decoder `d28dec.py`: nothing here imports the codec under
test, and the pictures come from `d28dec` alone. Lossless semantics are
decode(encode(x)) == x, so the reference is the decoder and the source
frames; no plain encoder is needed.

`lossless_faults` walks the stream as `check.encode_faults` does (its
structural faults are `encode_faults`'s own, read with no picture to
decode) and decodes each picture it is given the source of, counting
the samples of Y, U and V that differ from the source frame's.
"""
import numpy as np

from . import check, d28dec


def lossless_faults(stream, src, nframes, cfg, gop, eos, structure=True):
    """(faults, samples_differing, mse_y) of one encoded stream of
    `nframes` frames at -gop=`gop` under configuration `cfg`; `src` maps
    picture indices to their source frames' (y, u, v) planes.

    faults: with `structure`, `check.encode_faults`'s faults of the
    stream's structure; for each picture index in `src`, decoded with
    the pictures from the intra picture before it, a picture missing or
    one the decoder rejects, a plane failing the decoder's guards or its
    parse length, a frame number, picture size or plane shape other than
    the stream's, the configuration's and the source's.
    samples_differing: the samples of every plane of the pictures in
    `src` that differ from their source frame's; every sample of a
    picture that could not be compared (missing, rejected, misshapen)
    counts. mse_y lists the luma MSE of each picture compared."""
    faults = 0
    if structure:
        faults += check.encode_faults(stream, {}, nframes, cfg, gop, eos)[0]
    pkts, _ = check.packets(stream)
    pics, last_meta = [], None     # (index of the last metadata packet, type)
    for i, (t, _buf) in enumerate(pkts):
        if t == check.PT_META:
            last_meta = i
        elif t & check.PT_PIC and not t & check.PT_EOS:
            pics.append((last_meta, t, i))
    need = sorted(k for k in src if k < len(pics))
    faults += len(src) - len(need)
    runs = {}            # intra picture -> the pictures it leads to
    for k in need:
        first = k
        while first > 0 and pics[first][1] & 1:
            first -= 1
        runs.setdefault(first, []).append(k)
    differing, mses, compared = 0, [], set()
    for first, ks in sorted(runs.items()):
        meta_i = pics[first][0]
        if meta_i is None:
            faults += 1
            continue
        dec = d28dec.ConformanceDecoder()
        dec.decode_packet(pkts[meta_i][1])
        m = dec.meta or {}
        faults += (m.get("width"), m.get("height"), m.get("subsamp")) != (
            cfg["width"], cfg["height"], check.SUBSAMP[cfg["subsamp"]])
        for j in range(first, ks[-1] + 1):
            try:
                kind, vis, fno = dec.decode_packet(pkts[pics[j][2]][1])
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
            compared.add(j)
            differing += sum(int(np.count_nonzero(p != q))
                             for p, q in zip(vis, src[j]))
            d = vis[0].astype(np.float64) - src[j][0]
            mses.append(float(np.mean(d * d)))
        faults += dec.plane_faults
    differing += sum(sum(p.size for p in src[k]) for k in src
                     if k not in compared)
    return faults, differing, mses
