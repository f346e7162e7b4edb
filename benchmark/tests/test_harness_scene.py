"""The periodic scene: fixed by its seed, and periodic."""

import numpy as np

import cells
from scene import make_scene

MIX = dict(cells.traffic("dense22"), period=12, people=5)


def _scene(seed):
    return make_scene(MIX, 2, (256, 192), seed)


def _same(a, b):
    return (np.array_equal(a.images, b.images)
            and np.array_equal(a.gt_xy, b.gt_xy, equal_nan=True)
            and all(np.array_equal(x, y) for da, db in
                    zip(a.detections, b.detections) for x, y in zip(da, db)))


def test_one_seed_gives_one_scene_and_seeds_differ():
    big = 2 ** 31 + 12345              # above 32 signed bits
    assert _same(_scene(big), _scene(big))
    assert not _same(_scene(big), _scene(big + 1))


def test_frame_t_plus_p_equals_frame_t():
    s = _scene(99)
    p = s.period
    for t in (0, 5, 11):
        for k in (1, 3):
            img_a, det_a = s.frame(t)
            img_b, det_b = s.frame(t + k * p)
            assert np.array_equal(img_a, img_b)
            assert all(np.array_equal(x, y) for x, y in zip(det_a, det_b))
    gx, gy = s.gt_matrices(3 * p)
    assert np.array_equal(gx[:p], gx[p:2 * p])
    assert np.array_equal(gy[:p], gy[2 * p:])


def test_walkers_stay_in_the_arena_and_under_the_speed():
    s = make_scene(dict(MIX, period=128, people=22), 2, (256, 192), 5)
    xy = s.gt_xy
    assert np.nanmax(np.abs(xy)) <= MIX["arena_mm"] + 1e-6
    step = np.linalg.norm(np.roll(xy, -1, 0) - xy, axis=-1)
    assert np.nanmax(step) <= MIX["speed_mm"] + 1e-6
    gone = np.isnan(xy[..., 0]).any(0)
    assert gone.sum() == round(MIX["reentry_share"] * 22)


def test_window_mota_reads_the_engine_results_against_the_truth():
    """Results that report every person where the truth puts them score a
    MOTA of 1 over the window; dropping half of them lowers it."""
    import types

    import run
    s = _scene(7)
    first, last = 3, 20
    perfect, half = [], []
    for t in range(last + 1):
        xy = s.gt_xy[(t + s.offset) % s.period]
        keep = [p for p in range(len(xy)) if not np.isnan(xy[p, 0])]
        pts = np.asarray([[xy[p, 0], xy[p, 1], 0.0] for p in keep])
        perfect.append(types.SimpleNamespace(frame_idx=t, ids=keep,
                                             points=pts))
        half.append(types.SimpleNamespace(frame_idx=t, ids=keep[::2],
                                          points=pts[::2]))
    arena = MIX["arena_mm"]
    assert run.window_mota(perfect, s, first, last, arena).mota == 1.0
    assert run.window_mota(half, s, first, last, arena).mota < 0.7
