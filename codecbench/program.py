"""What the entry drivers take from the port (`dsv2_tpu_torch`): its
encoder factory and the build of its kernels. Imported by the drivers
only, never by the reference."""


def prepare(device):
    """Build (first run of a checkout) or load the port's CUDA kernels
    and its native host runtime, both cached inside the checkout under
    build/torch_kernels/ and build/torch_native/."""
    from dsv2_tpu_torch import native
    native.lib()
    if device.type == "cuda":
        from dsv2_tpu_torch.ops import _kernels
        for name in _kernels.build_all():
            for e in _kernels.entries(name):
                _kernels.entry(e)


def meta(cfg):
    from dsv2_tpu_torch.core import constants as K
    from dsv2_tpu_torch.utils.packet import VideoMeta
    sub = {"444": K.SUBSAMP_444, "422": K.SUBSAMP_422,
           "420": K.SUBSAMP_420, "411": K.SUBSAMP_411,
           "410": K.SUBSAMP_410}[cfg["subsamp"]]
    return VideoMeta(width=cfg["width"], height=cfg["height"], subsamp=sub,
                     fps_num=cfg["fps_num"], fps_den=cfg["fps_den"])


def encoder(cfg, gop, device, hme_backend=None):
    """An encoder as the CLI builds it: `-qp` and `-gop`; every other flag
    at its default."""
    from dsv2_tpu_torch import cli
    enc = cli.make_encoder(meta(cfg), cli.default_enc_opts(qp=cfg["qp"],
                                                           gop=gop),
                           device=device)
    if hme_backend is not None:
        enc.hme_backend = hme_backend
    return enc


def lane_clips(cfg, traffic, seed):
    """The seeded clip of lanes x frames_per_lane frames, cut into
    consecutive lanes."""
    from codecbench import clip
    n, per = traffic["lanes"], traffic["frames_per_lane"]
    frames = clip.make_clip(cfg["width"], cfg["height"], n * per,
                            cfg["subsamp"], seed)
    return [frames[i * per:(i + 1) * per] for i in range(n)]


def encode_lanes(cfg, traffic, lanes, device):
    """The lanes' streams through one lockstep call of the port."""
    from dsv2_tpu_torch.parallel import dynbatch

    def factory():
        return encoder(cfg, traffic["gop"], device,
                       traffic.get("hme_backend"))
    return dynbatch.encode_streams_lockstep(
        lanes, factory, width=traffic["width"], groups=traffic["groups"])
