"""Packet framing: headers, link offsets, metadata packets, stream reading.

Wire layout per B.1 of the format (ref: src/dsv.h:31-50, src/dsv_encoder.c:
934-990, src/dsv_main.c:907-957).
"""
import struct
from dataclasses import dataclass

from ..bitstream import BitWriter, BitReader
from ..core import constants as K


@dataclass
class VideoMeta:
    width: int = 352
    height: int = 288
    subsamp: int = K.SUBSAMP_420
    fps_num: int = 30
    fps_den: int = 1
    aspect_num: int = 1
    aspect_den: int = 1
    inter_sharpen: int = 1
    reserved: int = 0


def write_packet_hdr(w: BitWriter, pkt_type: int):
    for b in K.FOURCC:
        w.put_bits(8, b)
    w.put_bits(8, K.VERSION_MINOR)
    w.put_bits(8, pkt_type)
    w.put_bits(32, 0)  # prev link
    w.put_bits(32, 0)  # next link


def parse_packet_hdr(r: BitReader):
    """Returns packet type or None on bad fourcc."""
    cc = bytes(r.get_bits(8) for _ in range(4))
    if cc != K.FOURCC:
        return None
    r.get_bits(8)  # version minor
    pkt_type = r.get_bits(8)
    r.get_bits(32)
    r.get_bits(32)
    return pkt_type


def set_link_offsets(buf: bytearray, prev_link: int, next_link: int):
    struct.pack_into(">I", buf, K.PACKET_PREV_OFFSET, prev_link & 0xFFFFFFFF)
    struct.pack_into(">I", buf, K.PACKET_NEXT_OFFSET, next_link & 0xFFFFFFFF)


def encode_metadata(meta: VideoMeta) -> bytes:
    """Metadata packet (ref: dsv_encoder.c:951-990)."""
    w = BitWriter(64)
    write_packet_hdr(w, K.PT_META)
    w.put_ueg(meta.width)
    w.put_ueg(meta.height)
    w.put_ueg(meta.subsamp)
    w.put_ueg(meta.fps_num)
    w.put_ueg(meta.fps_den)
    w.put_ueg(meta.aspect_num)
    w.put_ueg(meta.aspect_den)
    w.put_ueg(meta.inter_sharpen)
    w.put_bit(0)
    w.align()
    data = bytearray(w.data())
    struct.pack_into(">I", data, K.PACKET_NEXT_OFFSET, len(data))
    return bytes(data)


def decode_metadata(r: BitReader) -> VideoMeta:
    m = VideoMeta()
    m.width = r.get_ueg()
    m.height = r.get_ueg()
    m.subsamp = r.get_ueg()
    m.fps_num = r.get_ueg()
    m.fps_den = r.get_ueg()
    m.aspect_num = r.get_ueg()
    m.aspect_den = r.get_ueg()
    m.inter_sharpen = r.get_ueg()
    m.reserved = r.get_bits(15) if r.get_bit() else 0
    return m


def encode_eos() -> bytes:
    w = BitWriter(16)
    write_packet_hdr(w, K.PT_EOS)
    return w.data()


def read_packet(stream):
    """Reads one packet using the next-link size field. Returns
    (pkt_type, payload bytes) or (None, None) at EOF / error
    (ref: dsv_main.c:912-957)."""
    hdr = stream.read(K.PACKET_HDR_SIZE)
    if len(hdr) < K.PACKET_HDR_SIZE:
        return None, None
    if hdr[:4] != K.FOURCC:
        return None, None
    size = struct.unpack_from(">I", hdr, K.PACKET_NEXT_OFFSET)[0]
    if size == 0:
        size = K.PACKET_HDR_SIZE
    if size < K.PACKET_HDR_SIZE:
        return None, None
    rest = stream.read(size - K.PACKET_HDR_SIZE)
    if len(rest) < size - K.PACKET_HDR_SIZE:
        return None, None
    return hdr[K.PACKET_TYPE_OFFSET], hdr + rest


def iter_packets(stream):
    while True:
        t, buf = read_packet(stream)
        if t is None:
            return
        yield t, buf
