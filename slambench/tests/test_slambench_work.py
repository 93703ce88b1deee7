"""The per-stage least work behind `frontend_roofline.live` depends only on
the cell's shapes and feature count."""

import inspect

from slambench import work


def test_counts_take_only_shapes_and_feature_counts():
    assert list(inspect.signature(work.stages).parameters) == [
        "h", "w", "n_features", "n_levels", "scale_factor"]
    a = work.stages(480, 752, 1200, 8, 1.2)
    assert a == work.stages(480, 752, 1200, 8, 1.2)
    assert set(a) == {"pyramid", "fast", "select", "orientation", "blur", "brief",
                      "stereo_match", "pack"}


def test_counts_grow_with_pixels_and_features():
    base = work.least_seconds(480, 752, 1200, 8, 1.2)
    assert work.least_seconds(376, 1241, 1200, 8, 1.2) > base  # 1.29x the pixels
    assert work.least_seconds(480, 752, 2000, 8, 1.2) > base
    assert 1e-6 < base < 1e-4  # microseconds: a frame's least time on the card


def test_fast_stage_counts_the_detection_crops():
    n_bytes, ops = work.stages(480, 752, 1200, 8, 1.2)["fast"]
    crop = sum((h - 32) * (w - 32) for h, w in work.level_sizes(480, 752, 8, 1.2))
    assert n_bytes == 2 * crop
    assert ops == [(2 * crop * work.FAST_OPS_PER_PX, work.INT16X2_OPS_PER_S)]
