"""Per-frame static parameters shared by the device ops.

Port of `_PCfg` from `dsv2_tpu/codec/decoder.py`; the decoder session
itself is not ported yet (ROADMAP item 16).
"""
from dsv2_tpu.core import intmath as im
from dsv2_tpu.core.frame import coef_dims, plane_dims

from ..ops import hzcc, sbt


class _PCfg:
    """Per-frame static parameters shared by the device ops."""

    def __init__(self, meta, blk_w, blk_h, isP, lossless, do_psy=0):
        self.meta = meta
        self.blk_w, self.blk_h = blk_w, blk_h
        self.nbh = im.udiv_round_up(meta.width, blk_w)
        self.nbv = im.udiv_round_up(meta.height, blk_h)
        self.isP = isP
        self.lossless = lossless
        self.do_psy = do_psy
        self.cdims = coef_dims(meta.subsamp, meta.width, meta.height)
        self.pdims = plane_dims(meta.subsamp, meta.width, meta.height)

    @property
    def psyf_all(self):
        return hzcc.spatial_psy_factor(self, -1)

    def hzcc_cfg(self, c):
        cw, ch = self.cdims[c]
        return hzcc.HzccCfg(cw, ch, c == 0, self.isP, self.lossless,
                            self.nbh, self.nbv, self.blk_w, self.blk_h,
                            self.meta.width, self.meta.height,
                            self.meta.subsamp, self.do_psy)

    def sbt_cfg(self, c):
        cw, ch = self.cdims[c]
        return sbt.SbtCfg(cw, ch, c == 0, self.isP, self.lossless,
                          self.nbh, self.nbv)
