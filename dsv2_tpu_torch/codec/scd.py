"""Scene-change detection + motion statistics (host scalar port).

(ref: src/dsv_encoder.c:129-250, 545-651)
"""
import numpy as np

from ..core import constants as K
from ..core import intmath as im
from ..core import mvmath


def neighbordif2_grid(mf, p):
    """Vectorized per-block (ndx, ndy) (ref: dsv.c:402-438)."""
    nbh, nbv = p.nbh, p.nbv
    x = mf.grid(mf.x).astype(np.int32)
    y = mf.grid(mf.y).astype(np.int32)
    skip = mf.grid(mf.bit(K.MV_BIT_SKIP))
    nz = (x != 0) | (y != 0)

    def nb(sx_, sy_, ok, svalid):
        vx = np.where(svalid, sx_, x)
        vy = np.where(svalid, sy_, y)
        return np.abs(vx - x) + np.abs(vy - y)

    lx = np.roll(x, 1, axis=1)
    ly = np.roll(y, 1, axis=1)
    lok = np.zeros_like(skip)
    lok[:, 1:] = (~skip[:, :-1]) & nz[:, :-1]
    tx = np.roll(x, 1, axis=0)
    ty = np.roll(y, 1, axis=0)
    tok = np.zeros_like(skip)
    tok[1:, :] = (~skip[:-1, :]) & nz[:-1, :]
    d0 = nb(lx, ly, None, lok)
    d1 = nb(tx, ty, None, tok)
    small = (np.abs(x) < 2) & (np.abs(y) < 2)
    d0 = np.where(small, 0, d0)
    d1 = np.where(small, 0, d1)
    return d0, d1


def avg_motion(enc, mf, p):
    """(ref: dsv_encoder.c:129-176)."""
    nbh, nbv = p.nbh, p.nbv
    skip = mf.bit(K.MV_BIT_SKIP)
    avgx = int(mf.x[~skip].astype(np.int64).sum())
    avgy = int(mf.y[~skip].astype(np.int64).sum())
    d0, d1 = neighbordif2_grid(mf, p)
    chaos_m = (~skip.reshape(nbv, nbh)) & ((d0 > 4) | (d1 > 4))
    chaos = int(chaos_m.sum())
    stat = nbh * nbv - chaos
    nblk = nbh * nbv
    avgx = (abs(avgx) + abs(avgy)) // (nblk * 2)
    avgx = max(avgx, 1)
    enc.curr_avgmot = avgx
    enc.motion_static = stat * 100 // nblk
    chaos = chaos * 100 // nblk
    if enc.prev_chaos < 0:
        enc.motion_chaos = chaos
        enc.prev_chaos = enc.motion_chaos
    else:
        enc.prev_chaos = (enc.prev_chaos + enc.motion_chaos) // 2
        enc.motion_chaos = chaos
    return avgx


def _mv_cost(mf, p, i, j, mx, my, q):
    return mvmath.mv_cost(mf.x, mf.y, p.nbh, p.blk_w, p.blk_h,
                          p.meta.width, p.meta.height, i, j, mx, my, q, 0)


def scene_complexity(enc, mf, p):
    """(ref: dsv_encoder.c:179-250)."""
    nbh, nbv = p.nbh, p.nbv
    skip = mf.grid(mf.bit(K.MV_BIT_SKIP))
    intra = mf.grid(mf.bit(K.MV_BIT_INTRA))
    allmask = mf.grid(mf.submask) == K.MASK_ALL_INTRA
    costs = mvmath.mv_cost_grid(
        mf.grid(mf.x), mf.grid(mf.y), p.blk_w, p.blk_h,
        p.meta.width, p.meta.height, enc.prev_quant, 0)
    if enc.rc_mode == K.RC_ABR:
        maxpot = _mv_cost(mf, p, 0, 0, 64, 64, enc.prev_quant)
        maxpot += 12
        maxpot += 64
        maxpot = (maxpot * (nbh * nbv) + 1) >> 1
        complexity = int(np.where(~skip, costs
                                  + mf.grid(mf.err).astype(np.int64)
                                  - enc.avg_err, 0).sum())
        complexity += int(np.where(intra, np.where(allmask, 16, 4), 0).sum())
    elif enc.rc_mode == K.RC_CRF:
        maxpot = 70 * nbh * nbv
        complexity = int(np.where(skip, -100, costs).sum())
        complexity += int(np.where(intra, np.where(allmask, 100, 40),
                                   0).sum())
    else:
        return 0
    if complexity <= 0:
        return 0
    return complexity * 100 // maxpot


def scene_change_detection(enc, d):
    """(ref: dsv_encoder.c:545-651). Returns 1 when an I frame is forced."""
    p = d.params
    mf = d.final_mvs
    SQR = lambda x: x * x
    intra_pct = enc.curr_intra_pct
    scblocks = enc.curr_scblocks
    avgmot = avg_motion(enc, mf, p)
    chaos = enc.motion_chaos
    dchaos = abs(chaos - enc.prev_chaos)
    gopdiv = abs(enc.gop) * 3 // 4
    closeness = int(d.fnum) - int(enc.prev_gop)
    complexity = scene_complexity(enc, mf, p)
    closefac = im.divt(closeness, max(gopdiv, 1))
    if complexity > 256 and chaos < 5:
        shift = 9
    elif complexity > chaos * 2:
        shift = 8
    elif complexity > chaos:
        shift = 7
    else:
        shift = 6
    tipct = SQR(intra_pct) >> 5
    likely_sc = 1 if (intra_pct * 3 // 2 > scblocks) else 0
    likely_sc += 1 if (tipct > scblocks) else 0
    if scblocks > enc.scene_change_pct and chaos < 34:
        scblocks = SQR(scblocks * 2) // max(enc.scene_change_pct, 1)
        likely_sc += 1
    else:
        scblocks = SQR(scblocks) // max(enc.scene_change_pct, 1)
    shift = max(shift - likely_sc, 5)
    blks = (max(dchaos // 16 + enc.avg_err // 8, 1) * scblocks
            * max(complexity, 1) * max(closefac, 1)) >> (shift + 1)
    sc = (enc.do_scd and ((blks > 120)
          or (blks > enc.scene_change_pct and avgmot < 20
              and enc.motion_chaos <= max(enc.prev_chaos - 10, 30))))
    high_intra = intra_pct > enc.intra_pct_thresh
    if sc or high_intra:
        p.has_ref = 0
        return 1
    enc.curr_complexity = complexity

    skip = mf.bit(K.MV_BIT_SKIP)
    enc.intra_map |= mf.bit(K.MV_BIT_INTRA).astype(np.uint8)
    imap = enc.intra_map.astype(bool)
    zerov = skip | ((mf.x == 0) & (mf.y == 0))
    maint = mf.bit(K.MV_BIT_MAINTAIN)
    noxy = mf.bit(K.MV_BIT_NOXMITY)
    nintra = int(np.where(imap & zerov, np.where(maint, 3, 1),
                          np.where(imap & noxy & maint, 1, 0)).sum())
    skipn = int(np.where(imap & zerov, np.where(maint, 2, 1), 0).sum())
    nintra += int(enc.intra_map.sum())
    nblk = p.nbh * p.nbv
    nintra = nintra * 100 // nblk
    skipn = skipn * 100 // nblk
    if (nintra > enc.intra_pct_thresh and enc.curr_avgmot < 10
            and enc.motion_chaos <= im.clamp(enc.prev_chaos // 2 + skipn,
                                             20, 40)):
        p.has_ref = 0
        return 1
    return 0
