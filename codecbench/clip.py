"""Seeded synthetic clips, the inputs of every cell.

The pattern is the repository's fixture pattern, frozen here: a moving
diagonal gradient under a static edge grid, a moving square of noise
texture, and an optional second scene (a radial pattern, slow pan) from
`scene_cut` on. `synth_frame` and `subsample` are copied unchanged;
what the seed sets is the random generator (the square's texture, drawn
anew every frame) and the clip's starting phase `t`.

`make_clip` computes the same planes as calling `synth_frame` frame by
frame, with the parts that do not move computed once: an FHD frame takes
milliseconds instead of a fifth of a second, and set-up pays for every
frame of a clip in every run. codecbench/tests/test_codecbench_clip.py
holds it to the frame-by-frame form.
"""
import numpy as np

# chroma shifts (horizontal, vertical) of each y4m chroma tag
SUBS = {"444": (0, 0), "422": (1, 0), "420": (1, 1), "411": (2, 0),
        "410": (2, 2)}
PHASES = 1 << 16   # the starting phase t is drawn from [0, PHASES)


def synth_frame(w, h, t, rng, scene=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
    if scene == 0:
        # moving diagonal gradient + moving textured square + static edge grid
        y = (xx * 2 + yy + t * 3) % 256
        y = (y // 2 + 64).astype(np.int64)
        # static high-contrast grid (edges)
        y[(xx // 16 + yy // 16) % 2 == 0] //= 2
        # moving square with noise texture
        sqh, sqw = min(20, h), min(24, w)
        sx, sy = (t * 5) % max(w - sqw, 1), (t * 3) % max(h - sqh, 1)
        tex = rng.integers(0, 90, (20, 24))
        y[sy:sy + sqh, sx:sx + sqw] = 120 + tex[:sqh, :sqw]
    else:
        # second scene: radial pattern, slow pan
        cx, cy = w // 2 + t, h // 3
        r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2).astype(np.int64)
        y = (r * 4) % 200 + 28
    u = ((xx + t * 2) % 256) // 2 + 64
    v = ((yy * 2 - t) % 256) // 2 + 64
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


def subsample(p, sh, sv):
    # simple box average matching chroma generation (content is synthetic,
    # any downsample is fine — it just defines the input planes)
    if sh == 0 and sv == 0:
        return p
    h, w = p.shape
    fw, fh = 1 << sh, 1 << sv
    w2, h2 = -(-w // fw), -(-h // fh)
    pad = np.pad(p, ((0, h2 * fh - h), (0, w2 * fw - w)), mode="edge")
    return pad.reshape(h2, fh, w2, fw).mean(axis=(1, 3)).astype(np.uint8)


def rng_of(seed):
    """The clip's random generator: any whole number is a seed."""
    return np.random.default_rng(int(seed) % (1 << 63))


def sample_rng(seed):
    """The generator that draws what the check samples: seeded like the
    clip, on a stream of its own."""
    return np.random.default_rng([int(seed) % (1 << 63), 1])


def make_clip(w, h, nframes, subs, seed, scene_cut=None):
    """`nframes` frames, each a (y, u, v) tuple of uint8 planes, of the
    pattern at w x h in chroma format `subs` ("420", ...), from `seed`."""
    sh, sv = SUBS[subs]
    rng = rng_of(seed)
    t0 = int(rng.integers(0, PHASES))
    yy = np.arange(h, dtype=np.int64)[:, None]
    xx = np.arange(w, dtype=np.int64)[None, :]
    diag = xx * 2 + yy
    grid = (xx // 16 + yy // 16) % 2 == 0
    sqh, sqw = min(20, h), min(24, w)
    h2 = -(-h // (1 << sv))
    w2 = -(-w // (1 << sh))
    frames = []
    for i in range(nframes):
        t = t0 + i
        if scene_cut is not None and i >= scene_cut:
            y, u, v = synth_frame(w, h, t, rng, 1)
            frames.append((y, subsample(u, sh, sv), subsample(v, sh, sv)))
            continue
        y = (diag + t * 3) % 256 // 2 + 64
        y[grid] //= 2
        sx, sy = (t * 5) % max(w - sqw, 1), (t * 3) % max(h - sqh, 1)
        tex = rng.integers(0, 90, (20, 24))
        y[sy:sy + sqh, sx:sx + sqw] = 120 + tex[:sqh, :sqw]
        # u varies along x only and v along y only: subsample one band of
        # rows (columns) and repeat it, which the box average leaves equal
        u_row = ((xx + t * 2) % 256 // 2 + 64).astype(np.uint8)
        v_col = ((yy * 2 - t) % 256 // 2 + 64).astype(np.uint8)
        u = subsample(np.repeat(u_row, 1 << sv, axis=0), sh, sv)
        v = subsample(np.repeat(v_col, 1 << sh, axis=1), sh, sv)
        frames.append((y.astype(np.uint8),
                       np.ascontiguousarray(np.broadcast_to(u, (h2, w2))),
                       np.ascontiguousarray(np.broadcast_to(v, (h2, w2)))))
    return frames
