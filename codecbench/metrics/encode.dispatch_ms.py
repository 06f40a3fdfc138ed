"""encode.dispatch_ms (ms/frame, layer codec): a single stream's host
enqueue of its one-frame device steps, per frame encoded: the spans
`encode.dispatch.<key>` inside `encode_frame` over the window, less the
`sync` spans inside them (codecbench/frame_spans.py). The counterpart of
`enqueue_ms` outside lockstep. None where the port keeps no records or
has no such span."""
from codecbench.frame_spans import per_frame_ms


def read(obs):
    return per_frame_ms(obs, "dispatch")
