"""Tile pre-segmentation flood vs the NumPy connected-components oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from video_segment_tpu.ops import tile_preseg


def test_tile_preseg_matches_oracle(rng):
    vol = (rng.random((2, 16, 140, 3)) < 0.5).astype(np.float32) * 0.6
    got = np.asarray(tile_preseg.tile_presegment(jnp.asarray(vol), 0.01,
                                                 iters=64))
    want = tile_preseg.tile_preseg_reference(vol, 0.01)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,metric", [((1, 40, 300), "l2"),
                                          ((3, 8, 128), "l1")])
def test_tile_preseg_matches_oracle_shapes(shape, metric):
    """Smooth texture with flat patches at a height and width that are
    not multiples of the tile; the flood runs to convergence
    (TILE_H * TILE_W iterations bound any in-tile path)."""
    rng = np.random.default_rng(3)
    t, h, w = shape
    patches = rng.random((t, h // 4 + 1, w // 4 + 1, 3))
    vol = patches.repeat(4, axis=1).repeat(4, axis=2)[:, :h, :w]
    vol = (vol + rng.random(shape + (3,)) * 0.004).astype(np.float32)
    got = np.asarray(tile_preseg.tile_presegment(
        jnp.asarray(vol), 0.01, metric,
        iters=tile_preseg.TILE_H * tile_preseg.TILE_W))
    want = tile_preseg.tile_preseg_reference(vol, 0.01, metric)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) < got.size // 4    # the flood did merge


def test_tile_preseg_threshold_zero_noise(rng):
    vol = rng.random((1, 8, 128, 3)).astype(np.float32)
    got = np.asarray(tile_preseg.tile_presegment(jnp.asarray(vol), 1e-9))
    # Continuous noise: nobody merges.
    assert len(np.unique(got)) == 8 * 128


def test_tile_preseg_uniform(rng):
    vol = np.full((1, 8, 128, 3), 0.5, np.float32)
    got = np.asarray(tile_preseg.tile_presegment(jnp.asarray(vol), 0.01,
                                                 iters=160))
    assert len(np.unique(got)) == 1
    assert got[0, 0, 0] == 0
