"""Per-frame block metadata (de)serialization.

Stability/skip block masks, ringing/maintain intra masks and the motion
field's five subsections (MODE / MV_X / MV_Y / SBIM / EPRM); the MV residual
coding depends on already-(de)serialized neighbors, so this is a host raster
loop over the (small) block grid.
(ref: src/dsv_decoder.c:81-238, src/dsv_encoder.c:691-932)
"""
import numpy as np

from ..bitstream import BitWriter, BitReader, ZBRLEReader
from ..core import constants as K
from ..core import intmath as im
from ..core import mvmath


class MotionField:
    """Struct-of-arrays MV field over the block grid."""

    def __init__(self, nbh, nbv):
        self.nbh, self.nbv = nbh, nbv
        n = nbh * nbv
        self.x = np.zeros(n, dtype=np.int16)
        self.y = np.zeros(n, dtype=np.int16)
        self.flags = np.zeros(n, dtype=np.uint32)
        self.err = np.zeros(n, dtype=np.uint16)
        self.dc = np.zeros(n, dtype=np.uint16)
        self.submask = np.zeros(n, dtype=np.uint8)

    def bit(self, bitpos):
        return (self.flags & (1 << bitpos)) != 0

    def set_bit(self, idx, bitpos, on):
        if on:
            self.flags[idx] |= (1 << bitpos)
        else:
            self.flags[idx] &= ~np.uint32(1 << bitpos)

    def grid(self, a):
        return a.reshape(self.nbv, self.nbh)


def decode_stability_blocks(r: BitReader, buf, nblk, isP, stats):
    """(ref: dsv_decoder.c:176-198). Returns blockdata uint8[nblk]."""
    r.align()
    ln = r.get_ueg()
    r.align()
    rle = ZBRLEReader(buf, r.byte_pos * 8)
    r.skip_bytes(ln)
    shift = K.SKIP_BIT if isP else K.STABLE_BIT
    blockdata = np.zeros(nblk, dtype=np.uint8)
    inv = stats[K.STABLE_STAT] == K.ZERO_MARKER
    for i in range(nblk):
        bit = rle.get()
        if inv:
            bit = 1 - bit
        blockdata[i] = bit << shift
    return blockdata


def decode_intra_meta(r: BitReader, buf, nblk, stats, blockdata):
    """(ref: dsv_decoder.c:201-238)."""
    r.align()
    ln = r.get_ueg()
    r.align()
    rle_r = ZBRLEReader(buf, r.byte_pos * 8)
    r.skip_bytes(ln)
    r.align()
    ln = r.get_ueg()
    r.align()
    rle_m = ZBRLEReader(buf, r.byte_pos * 8)
    r.skip_bytes(ln)
    inv_r = stats[K.RINGING_STAT] == K.ZERO_MARKER
    inv_m = stats[K.MAINTAIN_STAT] == K.ZERO_MARKER
    for i in range(nblk):
        bitr = rle_r.get()
        bitm = rle_m.get()
        if inv_r:
            bitr = 1 - bitr
        if inv_m:
            bitm = 1 - bitm
        blockdata[i] |= (bitm << K.MAINTAIN_BIT) | (bitr << K.RINGING_BIT)


def decode_motion(r: BitReader, buf, nbh, nbv, stats, blockdata):
    """(ref: dsv_decoder.c:81-173). Returns a MotionField."""
    r.align()
    readers = []
    for i in range(K.SUB_NSUB):
        ln = r.get_ueg()
        r.align()
        if i in (K.SUB_MODE, K.SUB_EPRM):
            readers.append(ZBRLEReader(buf, r.byte_pos * 8))
        else:
            readers.append(BitReader(buf, r.byte_pos * 8))
        r.skip_bytes(ln)
    rle, prrle = readers[K.SUB_MODE], readers[K.SUB_EPRM]
    bx, by = readers[K.SUB_MV_X], readers[K.SUB_MV_Y]
    bim = readers[K.SUB_SBIM]

    mf = MotionField(nbh, nbv)
    skip = np.zeros(nbh * nbv, dtype=bool)
    inv_mode = stats[K.MODE_STAT] == K.ZERO_MARKER
    inv_eprm = stats[K.EPRM_STAT] == K.ZERO_MARKER
    for j in range(nbv):
        for i in range(nbh):
            idx = i + j * nbh
            if blockdata[idx] & K.IS_SKIP:
                mf.set_bit(idx, K.MV_BIT_SKIP, 1)
                mf.x[idx] = mf.y[idx] = 0
                skip[idx] = True
                blockdata[idx] |= 1 << K.STABLE_BIT
                continue
            mode = rle.get()
            eprm = prrle.get()
            if inv_mode:
                mode = 1 - mode
            if inv_eprm:
                eprm = 1 - eprm
            mf.set_bit(idx, K.MV_BIT_INTRA, mode)
            mf.set_bit(idx, K.MV_BIT_EPRM, eprm)
            blockdata[idx] &= ~np.uint8(1 << K.STABLE_BIT)
            blockdata[idx] |= eprm << K.EPRM_BIT
            px, py = mvmath.movec_pred(mf.x, mf.y, nbh, i, j)
            if mode:
                px = im.sar_r(px, 2)
                py = im.sar_r(py, 2)
            mf.x[idx] = bx.get_seg() + px
            mf.y[idx] = by.get_seg() + py
            if mode:
                mf.x[idx] *= 4
                mf.y[idx] *= 4
                if bim.get_bit():
                    mf.submask[idx] = K.MASK_ALL_INTRA
                else:
                    mf.submask[idx] = bim.get_bits(4)
                if bim.get_bit():
                    mf.dc[idx] = bim.get_bits(8) | K.SRC_DC_PRED
                else:
                    mf.dc[idx] = 0
                blockdata[idx] |= K.IS_INTRA
            if mvmath.neighbordif(mf.x, mf.y, skip, nbh, i, j) > K.NDIF_THRESH:
                blockdata[idx] |= 1 << K.STABLE_BIT
    return mf


# --- encoder side ---

def encode_stable_blocks(w: BitWriter, stable_bits, stats):
    """stable_bits: iterable of 0/1 per block (already decided)
    (ref: dsv_encoder.c:797-883 serialization part)."""
    from .. import native
    inv = stats[K.STABLE_STAT] != K.ONE_MARKER
    blob = native.zbrle_encode(np.asarray(stable_bits, dtype=np.uint8) & 1,
                               inv)
    w.align()
    w.put_ueg(len(blob))
    w.align()
    w.concat_bytes(blob)


def encode_intra_meta(w: BitWriter, ring_bits, maintain_bits, stats):
    """(ref: dsv_encoder.c:886-932)."""
    from .. import native
    for bits, stat in ((ring_bits, K.RINGING_STAT),
                       (maintain_bits, K.MAINTAIN_STAT)):
        inv = stats[stat] != K.ONE_MARKER
        blob = native.zbrle_encode(np.asarray(bits, dtype=np.uint8) & 1, inv)
        w.align()
        w.put_ueg(len(blob))
        w.align()
        w.concat_bytes(blob)


def encode_motion(w: BitWriter, mf: MotionField, stats, blockdata):
    """Serialize the five motion subsections (ref: dsv_encoder.c:692-794).
    NOTE: mutates intra MVs to their transmitted full-pel precision and
    updates blockdata's EPRM/STABLE bits exactly like the reference. The
    raster STABLE decision reads already-rescaled neighbors, but since
    left/top/topleft always precede the current block, every value it reads
    is final — so the whole pass vectorizes; the serial bit layout runs in
    the native runtime."""
    from .. import native
    from ..codec import scd

    nbh, nbv = mf.nbh, mf.nbv
    inv_mode = stats[K.MODE_STAT] != K.ONE_MARKER
    inv_eprm = stats[K.EPRM_STAT] != K.ONE_MARKER
    skipf = mf.bit(K.MV_BIT_SKIP)
    act = ~skipf
    fl = mf.flags.astype(np.uint32)
    eprm = ((fl >> K.MV_BIT_EPRM) & 1).astype(np.uint8)
    intra = ((fl >> K.MV_BIT_INTRA) & 1).astype(bool)
    blockdata |= eprm << K.EPRM_BIT
    blockdata |= skipf.astype(np.uint8) << K.STABLE_BIT

    # transmitted values: intra MVs collapse to full-pel then scale back
    x0 = mf.x.astype(np.int64)
    y0 = mf.y.astype(np.int64)
    cvx = np.where(intra, x0 >> 2, x0)
    cvy = np.where(intra, y0 >> 2, y0)
    fin = intra & act
    mf.x[:] = np.where(fin, (x0 >> 2) * 4, x0).astype(np.int16)
    mf.y[:] = np.where(fin, (y0 >> 2) * 4, y0).astype(np.int16)

    xg = mf.x.astype(np.int64).reshape(nbv, nbh)
    yg = mf.y.astype(np.int64).reshape(nbv, nbh)
    px, py = mvmath.movec_pred_grid(xg, yg)
    px = px.reshape(-1)
    py = py.reshape(-1)
    px = np.where(intra, (px + 2) >> 2, px)
    py = np.where(intra, (py + 2) >> 2, py)

    class _P:
        pass
    _p = _P()
    _p.nbh, _p.nbv = nbh, nbv
    d0, d1 = scd.neighbordif2_grid(mf, _p)
    nd = (d0.reshape(-1) + d1.reshape(-1)) // 3
    blockdata |= ((act & (nd > K.NDIF_THRESH)).astype(np.uint8)
                  << K.STABLE_BIT)

    idxs = np.flatnonzero(act)
    blobs = [None] * K.SUB_NSUB
    blobs[K.SUB_MODE] = native.zbrle_encode(intra[idxs].astype(np.uint8),
                                            inv_mode)
    blobs[K.SUB_EPRM] = native.zbrle_encode(eprm[idxs], inv_eprm)
    blobs[K.SUB_MV_X] = native.seg_blob((cvx - px)[idxs])
    blobs[K.SUB_MV_Y] = native.seg_blob((cvy - py)[idxs])
    sb = idxs[intra[idxs]]
    blobs[K.SUB_SBIM] = native.sbim_blob(mf.submask[sb], mf.dc[sb],
                                         K.MASK_ALL_INTRA, K.SRC_DC_PRED)
    for blob in blobs:
        w.align()
        w.put_ueg(len(blob))
        w.align()
        w.concat_bytes(blob)
