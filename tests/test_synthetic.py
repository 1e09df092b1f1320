"""The seeded synthetic clip generator."""

import numpy as np
import pytest

from video_segment_tpu.dataio.synthetic import synthetic_clip


def test_generator_is_deterministic():
    a = synthetic_clip(97, 33, 5, seed=3)
    b = synthetic_clip(97, 33, 5, seed=3)
    assert a.shape == (5, 33, 97, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert (synthetic_clip(97, 33, 5, seed=4) != a).mean() > 0.5


def test_generator_pans_and_moves():
    clip = synthetic_clip(160, 96, 12, seed=0).astype(np.int32)
    # Consecutive frames differ (pan, moving object, noise) but the pan
    # aligns the background: shifting frame t+1 back by (1, 2) pixels
    # matches frame t far better than no shift does.
    a, b = clip[5], clip[6]
    still = np.abs(a[10:-10, 10:-10] - b[10:-10, 10:-10]).mean()
    panned = np.abs(a[11:-9, 12:-8] - b[10:-10, 10:-10]).mean()
    assert panned < 0.5 * still


def test_generator_rejects_tiny_clips():
    with pytest.raises(ValueError):
        synthetic_clip(4, 4, 1)
