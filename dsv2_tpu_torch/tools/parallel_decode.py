#!/usr/bin/env python
"""GOP-parallel decode (port of tools/parallel_decode.py): the closed
GOPs of a stream decode concurrently, one lane thread per GOP, each
device chain step batched over the lanes (parallel/gop.
decode_gops_parallel). The y4m equals the sequential decode's
(`python -m dsv2_tpu_torch d -y4m=1`).

    python -m dsv2_tpu_torch.tools.parallel_decode IN.dsv OUT.y4m [width]

`width` is the most lanes one flush runs at once (default: every GOP).
Runs on the card unless DSV2_TORCH_DEVICE=cpu.
"""
import io
import sys

from ..bitstream import BitReader
from ..core import constants as K
from ..parallel.gop import decode_gops_parallel
from ..utils import packet, y4m


def stream_meta(data):
    """The first metadata packet's VideoMeta of a stream, or None."""
    for t, buf in packet.iter_packets(io.BytesIO(data)):
        if t == K.PT_META:
            r = BitReader(buf)
            packet.parse_packet_hdr(r)
            return packet.decode_metadata(r)
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    src, out = argv[0], argv[1]
    width = int(argv[2]) if len(argv) > 2 else None
    with open(src, "rb") as f:
        data = f.read()
    meta = stream_meta(data)
    if meta is None:
        raise SystemExit("no metadata packet found")
    frames = decode_gops_parallel(io.BytesIO(data), width=width)
    with open(out, "wb") as f:
        w = y4m.Y4MWriter(f, meta.width, meta.height, meta.subsamp,
                          fps=(meta.fps_num, meta.fps_den),
                          aspect=(meta.aspect_num, meta.aspect_den))
        for fr in frames:
            w.write_frame((fr.view(0), fr.view(1), fr.view(2)))
    print("%s: %d frames" % (out, len(frames)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
