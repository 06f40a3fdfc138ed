"""Plane-level coefficient coding: host framing around the device scan
blob or the native entropy scan (ref: src/hzcc.c:585-649).

Port of the encoder half of `dsv2_tpu/codec/plane.py`.
"""
from dsv2_tpu import native
from dsv2_tpu.bitstream import BitWriter
from dsv2_tpu.utils import log

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
