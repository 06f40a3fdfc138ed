"""Plane-level coefficient coding: host framing around the device scan
blob or the native entropy scan (ref: src/hzcc.c:585-649).

Port of `dsv2_tpu/codec/plane.py` for the blob transfer: the encoder's
framing and the decoder's `decode_plane`.
"""
import numpy as np

from .. import native
from ..bitstream import BitReader, BitWriter
from ..utils import log

from ..ops import hzcc

EOP_SYMBOL = 0x55


def _framed(w: BitWriter, ll_value, payload):
    """[32-bit length][SEG(ll)][payload][EOP], length patched last."""
    w.align()
    startp = w.byte_pos
    w.put_bits(32, 0)
    w.put_seg(int(ll_value))
    w.align()
    w.concat_bytes(payload)
    w.put_bits(8, EOP_SYMBOL)
    w.align()
    endp = w.byte_pos
    w.patch_bits(startp * 8, 32, (endp - startp) - 4)
    if log.get_level() >= log.LEVEL_INFO:
        log.info("encoded plane of size %d bytes", endp - startp)


def host_scan(v_scan, cw, ch):
    """The native entropy scan of one plane's quantized int32 scan array:
    the bytes a device scan blob must equal, and the payload of a plane
    on the per-plane contract fallback."""
    return native.scan_encode(v_scan, hzcc.scan_segments(cw, ch))


def encode_plane(w: BitWriter, v_scan, ll_value, cw, ch):
    """Append one coded plane from its quantized int32 scan array, coded
    by the native entropy scan; ll_value is the (unquantized) DC
    coefficient. The twin's unused dequantized-coefs argument is
    dropped."""
    _framed(w, ll_value, host_scan(v_scan, cw, ch))


def encode_plane_blob(w: BitWriter, blob, ll_value):
    """Append one coded plane from a device-built scan blob (ops/scan_pl):
    the entropy coding already happened on the device; the host frames
    it."""
    _framed(w, ll_value, blob.tobytes() if hasattr(blob, "tobytes")
            else blob)


def decode_plane(r: BitReader, cw, ch):
    """Returns (ok, ll_value, v_scan). Mirrors dsv_decode_plane's framing,
    error detection and skip-by-length behavior."""
    r.align()
    plen = r.get_bits(32)
    r.align()
    total = hzcc.total_scan_coefs(cw, ch)
    if not (0 < plen < cw * ch * 4 * 2):
        return False, 0, np.zeros(total, dtype=np.int32)
    start = r.byte_pos
    ll = r.get_seg()
    r.align()
    a0 = r.byte_pos
    lim = start + plen - a0
    buf = bytes(r.buf[a0:])
    v, endbit = native.scan_decode(np.frombuffer(buf, dtype=np.uint8), lim,
                                   total, hzcc.scan_segments(cw, ch))
    # verify the end-of-plane marker (ref: hzcc.c:604, 636-639)
    r.pos = a0 * 8 + endbit
    ok = r.get_bits(8) == EOP_SYMBOL
    r.align()
    r.seek_byte(start)
    r.skip_bytes(plen)
    return ok, ll, v
