"""GOP-parallel encode and decode (port of `dsv2_tpu/parallel/gop.py`).

Closed GOPs are independent: every GOP starts with its own metadata
packet and its link offsets are relative to the GOP, so per-GOP streams
byte-concatenate into one valid .dsv (ref: dsv_encoder.c:469-491,
1247-1251). `split_gops` and `encode_gops_parallel` cut a clip into
GOPs and encode them in host threads; `split_gop_packets` cuts a stream
back into its GOPs, and `decode_gops_parallel` decodes them in lockstep,
one lane thread per GOP with every device chain step batched over the
lanes (parallel/dynbatch), frame-equal to the sequential decode. The
twin's single-frame compile check (`device_intra_step`) and its mesh
"gop" axis are not ported: the port runs on one card.
"""
import concurrent.futures as cf

from ..core import constants as K
from ..utils import packet, trace
from ..utils.trace import stage


def split_gops(total_frames, gop):
    """Frame ranges [(start, end), ...] of independent closed GOPs."""
    if gop <= 0:
        return [(0, total_frames)]
    return [(s, min(s + gop, total_frames))
            for s in range(0, total_frames, gop)]


def encode_gops_parallel(frames, meta, gop, enc_factory, workers=None):
    """Encode the closed GOPs of `frames` with a sequential encoder each
    (enc_factory() -> a fresh encoder at -gop=`gop`), `workers` at a
    time in host threads; returns the concatenated stream with one
    end-of-stream packet, byte-equal to encoding the GOPs one after
    another. `meta` is the clip's (the encoders carry their own)."""
    ranges = split_gops(len(frames), gop)

    def encode_range(rng):
        enc = enc_factory()
        chunks = []
        for f in range(*rng):
            chunks.extend(enc.encode_frame(frames[f]))
        return b"".join(chunks)

    if workers is None or workers <= 1 or len(ranges) == 1:
        parts = [encode_range(r) for r in ranges]
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            parts = list(ex.map(encode_range, ranges))
    return b"".join(parts) + b"".join(enc_factory().end_of_stream())


def split_gop_packets(stream):
    """The packets [(type, buf), ...] of each independently decodable GOP
    of a .dsv stream (a file object), up to its end-of-stream packet: a
    GOP starts at each metadata packet (packets before the first one
    form a GOP of their own)."""
    chunks = []
    cur = None
    for t, buf in packet.iter_packets(stream):
        if t == K.PT_EOS:
            break
        if t == K.PT_META or cur is None:
            cur = []
            chunks.append(cur)
        cur.append((t, buf))
    return chunks


def decode_gops_parallel(stream, width=None, device=None):
    """Decode the GOPs of a .dsv stream (a file object) concurrently: one
    lane thread per GOP, each a Decoder whose device chain steps go
    through one LockstepBatcher of `width` lanes (default: every GOP),
    so a flush runs one lane-batched step for all lanes that reached it.
    Returns the Frames in stream order, equal to the sequential decode's.
    Each lane's host parse shows as `decode.parse`, its wait for the
    flush as `decode.submit` and its pixel fetch as `decode.fetch`."""
    from ..codec.decoder import DEC_EOS, DEC_OK, Decoder
    from .dynbatch import run_lanes

    chunks = split_gop_packets(stream)
    if not chunks:
        return []

    def lane(i, submit):
        trace.set_ids(lane=i)
        dec = Decoder(device=device)
        dec.dev_submit = submit
        frames, prev = [], None
        for _, buf in chunks[i]:
            with stage("decode.parse"):
                code, job, _ = dec.parse_packet(buf)
            if code == DEC_EOS:
                break
            if job is None:
                continue
            with stage("decode.submit"):
                code, realize, _ = dec._execute_job(job)
            if code != DEC_OK or realize is None:
                continue
            # fetch frame N after frame N+1's flush was queued: the parse
            # of the next packet overlaps the device work
            if prev is not None:
                with stage("decode.fetch"):
                    frames.append(prev())
            prev = realize
        if prev is not None:
            with stage("decode.fetch"):
                frames.append(prev())
        return frames

    results = run_lanes(len(chunks), width or len(chunks), lane)
    return [f for fs in results for f in fs]
