"""encode.host_ms (ms/frame, layer codec): a single stream's own host
work, per frame encoded: the `encode_frame` spans over the window less
every `encode.dispatch.<key>` and `sync` span inside them
(codecbench/frame_spans.py): rate control, scene change detection, the
mode and motion coding, the serializers and the uploads. With
`encode.dispatch_ms` and the `sync` seconds it tiles the frames' wall
time. None where the port keeps no records or has no dispatch span."""
from codecbench.frame_spans import per_frame_ms


def read(obs):
    return per_frame_ms(obs, "host")
