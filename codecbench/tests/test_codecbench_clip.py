"""The seeded clip: the fast form equals the frozen frame-by-frame
pattern, differs across seeds and repeats within one."""
import numpy as np
import pytest

from codecbench import clip


def frame_by_frame(w, h, n, subs, seed, scene_cut=None):
    sh, sv = clip.SUBS[subs]
    rng = clip.rng_of(seed)
    t0 = int(rng.integers(0, clip.PHASES))
    out = []
    for i in range(n):
        scene = 1 if scene_cut is not None and i >= scene_cut else 0
        y, u, v = clip.synth_frame(w, h, t0 + i, rng, scene)
        out.append((y, clip.subsample(u, sh, sv), clip.subsample(v, sh, sv)))
    return out


def same(a, b):
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for fa, fb in zip(a, b) for x, y in zip(fa, fb))


@pytest.mark.parametrize("w,h,subs,cut", [
    (64, 48, "420", None), (100, 62, "420", 2), (33, 17, "410", None),
    (50, 30, "422", 1), (40, 24, "444", None), (72, 20, "411", None),
    (352, 288, "420", None)])
def test_fast_clip_equals_pattern(w, h, subs, cut):
    assert same(clip.make_clip(w, h, 3, subs, 2 ** 31 + 5, cut),
                frame_by_frame(w, h, 3, subs, 2 ** 31 + 5, cut))


def test_fhd_frame_equals_pattern():
    assert same(clip.make_clip(1920, 1080, 1, "420", 12345),
                frame_by_frame(1920, 1080, 1, "420", 12345))


def test_seed_changes_clip_and_repeats():
    a = clip.make_clip(64, 48, 3, "420", 7)
    assert same(a, clip.make_clip(64, 48, 3, "420", 7))
    for other in (8, 2 ** 31 + 7, 2 ** 40):
        b = clip.make_clip(64, 48, 3, "420", other)
        assert not same(a, b)
