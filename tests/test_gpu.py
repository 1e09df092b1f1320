"""Pre-segmentation on the card: the plain-JAX felz and flood against
their NumPy references, and run-to-run repeatability.  Skips without a
GPU; `chip_smoke.py` runs these on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from video_segment_tpu.dataio.synthetic import synthetic_clip
from video_segment_tpu.ops import tile_felz, tile_preseg

pytestmark = pytest.mark.gpu

# chip_smoke.PARTITION_AGREEMENT: only the float summation order differs
# between the card's reductions and the mirror's.
PARTITION_AGREEMENT = 0.999
KW = dict(schedule=(4, 32, 96), fin_eager=True, fin_gated=True)


def _frame(h, w, seed):
    return (synthetic_clip(w, h, 1, seed).astype(np.float32) / 255.0)


def test_felz_on_gpu_matches_mirror(gpu):
    vol = _frame(272, 480, 0)
    lab, fin, _ = tile_felz.tile_felzenszwalb(jax.device_put(vol, gpu), **KW)
    lab_m, fin_m, _ = tile_felz.tile_felz_reference(vol, **KW)
    assert (np.asarray(lab) == lab_m).mean() >= PARTITION_AGREEMENT
    assert (np.asarray(fin) == fin_m).mean() > 0.97


def test_felz_on_gpu_repeats(gpu):
    vol = jax.device_put(_frame(272, 480, 1), gpu)
    a = tile_felz.tile_felzenszwalb(vol, **KW)
    b = tile_felz.tile_felzenszwalb(vol, **KW)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_flood_on_gpu_matches_oracle(gpu):
    vol = _frame(272, 480, 2)
    got = tile_preseg.tile_presegment(
        jax.device_put(vol, gpu), 0.01, "l2",
        iters=tile_preseg.TILE_H * tile_preseg.TILE_W)
    want = tile_preseg.tile_preseg_reference(vol, 0.01)
    assert (np.asarray(got) == want).mean() >= PARTITION_AGREEMENT
