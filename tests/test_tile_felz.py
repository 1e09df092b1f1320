"""Tile-felz pre-solve vs NumPy mirror, and the cell-stats init fast path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from video_segment_tpu.ops import tile_felz
from video_segment_tpu.core import oversegmentation as ov


def _textured(shape, seed):
    import scipy.ndimage as ndi
    base = np.random.default_rng(seed).random(shape + (3,))
    return ndi.gaussian_filter(base, (0, 2, 2, 0)).astype(np.float32)


@pytest.fixture(scope="module")
def textured_vol():
    return _textured((2, 24, 300), 7)


@pytest.mark.parametrize("shape", [(2, 24, 300), (1, 8, 256), (1, 16, 128),
                                   (1, 40, 200), (1, 272, 130)])
def test_kernel_matches_mirror(shape):
    """Plain-JAX pre-solve == sequential NumPy mirror at heights that are
    one, two, five and 34 tiles and widths that are or are not multiples
    of 128: exact labels, cell-positioned stats to f32 reduction
    tolerance, finalize levels in near-total agreement (fins trigger
    exactly at the merge threshold, so the mirror's float64 means
    legitimately flip borderline tests)."""
    vol = _textured(shape, 7)
    lab_k, fin_k, st_k = tile_felz.tile_felzenszwalb(
        jnp.asarray(vol), schedule=(4, 32, 96), fin_margin=1.5)
    lab_m, fin_m, st_m = tile_felz.tile_felz_reference(
        vol, schedule=(4, 32, 96), fin_margin=1.5)
    np.testing.assert_array_equal(np.asarray(lab_k), lab_m)
    agree = (np.asarray(fin_k) == fin_m).mean()
    assert agree > 0.97, f"fin agreement {agree}"
    size_k = np.asarray(st_k[0])
    np.testing.assert_allclose(size_k, st_m[0], atol=0.5)
    for ck, cm in zip(st_k[1:], st_m[1:]):
        np.testing.assert_allclose(np.asarray(ck), cm, rtol=1e-4,
                                   atol=1e-3)
    # Stats cover every pixel exactly once.
    t, h, w, _ = vol.shape
    assert size_k.sum() == t * h * w


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for j in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(j, "jaxpr", j)      # ClosedJaxpr -> Jaxpr
                if hasattr(inner, "eqns"):
                    yield from _dot_precisions(inner)


def test_contractions_ask_for_highest_precision():
    """Every dot_general of the pre-solve runs at Precision.HIGHEST (a
    float32 dot may otherwise run in TF32 on the GPU)."""
    vol = jnp.zeros((1, 8, 128, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda v: tile_felz.tile_felzenszwalb(
        v, schedule=(4, 32)))(vol)
    dots = list(_dot_precisions(jaxpr.jaxpr))
    assert dots, "no contraction found"
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in dots), dots


def test_kernel_fin_levels_exact_on_margined_fixture():
    """On a fixture whose merge tests clear the threshold by wide float
    margins, kernel and mirror agree EXACTLY, and the recorded finalize
    level is the failing edge's bucket: A (flat 0.100) | b1 (0.146) | b2
    (0.1558): b1+b2 merge at level 32 (bucket 20), the A|B test at level
    96 (bucket 94) then fails with region dd ~0.0509 >= 0.05."""
    h, w = 8, 128
    vol = np.full((1, h, w, 3), 0.100, np.float32)
    vol[:, :, 64:96] = 0.146
    vol[:, :, 96:] = 0.1558
    lab_k, fin_k, _ = tile_felz.tile_felzenszwalb(
        jnp.asarray(vol), schedule=(4, 32, 96), rounds_per_level=8,
        fin_margin=1.0)
    lab_m, fin_m, _ = tile_felz.tile_felz_reference(
        vol, schedule=(4, 32, 96), rounds_per_level=8, fin_margin=1.0)
    np.testing.assert_array_equal(np.asarray(lab_k), lab_m)
    np.testing.assert_array_equal(np.asarray(fin_k), fin_m)
    lab = np.asarray(lab_k)[0]
    assert len(np.unique(lab)) == 2                  # A and B=b1+b2
    assert len(np.unique(lab[:, 64:])) == 1          # b1 merged with b2
    bucket = int(abs(0.146 - 0.100) * 2048)
    np.testing.assert_array_equal(np.asarray(fin_k)[0],
                                  np.full((h, w), bucket))


def test_init_table_cell_stats_fast_path(textured_vol):
    """_init_table with cell stats gathers the same table the pixel
    segment-sum builds (means to f32 tolerance, memberships exact)."""
    vol = jnp.asarray(textured_vol[:1])
    lab, fin, stats = tile_felz.tile_felzenszwalb(
        vol, schedule=(4, 32, 96), fin_margin=1.5)
    n = int(np.prod(lab.shape))
    init = lab.reshape(-1).astype(jnp.int32)
    params = ov.OversegParams(edge_table=True)
    r_cap = 4096
    fin_flat = fin.reshape(-1)

    slow = ov._init_table(vol, init, None, None, fin_flat, r_cap, False,
                          params)
    fast = ov._init_table(vol, init, None, None, fin_flat, r_cap, False,
                          params, tuple(s.reshape(-1) for s in stats), 0)
    ts_s, memb_s, orig_s = slow
    ts_f, memb_f, orig_f = fast
    np.testing.assert_array_equal(np.asarray(memb_s), np.asarray(memb_f))
    np.testing.assert_array_equal(np.asarray(orig_s), np.asarray(orig_f))
    np.testing.assert_allclose(np.asarray(ts_s.size), np.asarray(ts_f.size),
                               atol=0.5)
    np.testing.assert_allclose(np.asarray(ts_s.csum), np.asarray(ts_f.csum),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(ts_s.fin), np.asarray(ts_f.fin))
    np.testing.assert_array_equal(np.asarray(ts_s.constr),
                                  np.asarray(ts_f.constr))


def test_kernel_matches_mirror_eager_gated(textured_vol):
    """fin_eager + fin_gated variants: kernel == mirror (exact labels),
    and eager freezing yields at least as many regions as level-end-only
    scans (earlier fins can only block merges)."""
    vol = textured_vol[:1]
    lab_base = None
    for eager, gated in ((True, False), (False, True), (True, True)):
        lab_k, fin_k, _ = tile_felz.tile_felzenszwalb(
            jnp.asarray(vol), schedule=(4, 32, 96),
            fin_eager=eager, fin_gated=gated)
        lab_m, fin_m, _ = tile_felz.tile_felz_reference(
            vol, schedule=(4, 32, 96), fin_eager=eager, fin_gated=gated)
        np.testing.assert_array_equal(np.asarray(lab_k), lab_m)
        agree = (np.asarray(fin_k) == fin_m).mean()
        assert agree > 0.97, f"fin agreement {agree} ({eager},{gated})"
        if lab_base is None:
            lab_d, _, _ = tile_felz.tile_felzenszwalb(
                jnp.asarray(vol), schedule=(4, 32, 96))
            lab_base = len(np.unique(np.asarray(lab_d)))
        if eager:
            assert len(np.unique(np.asarray(lab_k))) >= lab_base


def test_kernel_matches_mirror_pair_merge(textured_vol):
    """preseg_pair_merge (depth-1 hooking) variant: kernel == mirror, and
    cancelling chained hooks never produces fewer regions than chained
    rounds (chains only merge MORE per round)."""
    vol = textured_vol[:1]
    lab_k, fin_k, _ = tile_felz.tile_felzenszwalb(
        jnp.asarray(vol), schedule=(4, 32, 96),
        fin_eager=True, fin_gated=True, pair_merge=True)
    lab_m, fin_m, _ = tile_felz.tile_felz_reference(
        vol, schedule=(4, 32, 96),
        fin_eager=True, fin_gated=True, pair_merge=True)
    np.testing.assert_array_equal(np.asarray(lab_k), lab_m)
    agree = (np.asarray(fin_k) == fin_m).mean()
    assert agree > 0.97, f"fin agreement {agree}"


def test_kernel_matches_mirror_tuple_rounds(textured_vol):
    """Per-level round counts (rounds_per_level as a tuple): kernel ==
    mirror, and extra low-theta rounds only reduce the region count
    relative to the uniform-2 baseline (more in-tile convergence)."""
    vol = textured_vol[:1]
    kw = dict(schedule=(4, 32, 96), rounds_per_level=(8, 4, 2),
              fin_eager=True, fin_gated=True, pair_merge=True)
    lab_k, fin_k, _ = tile_felz.tile_felzenszwalb(jnp.asarray(vol), **kw)
    lab_m, fin_m, _ = tile_felz.tile_felz_reference(vol, **kw)
    np.testing.assert_array_equal(np.asarray(lab_k), lab_m)
    agree = (np.asarray(fin_k) == fin_m).mean()
    assert agree > 0.97, f"fin agreement {agree}"
    lab_u, _, _ = tile_felz.tile_felzenszwalb(
        jnp.asarray(vol), schedule=(4, 32, 96), rounds_per_level=2,
        fin_eager=True, fin_gated=True, pair_merge=True)
    assert (len(np.unique(np.asarray(lab_k)))
            <= len(np.unique(np.asarray(lab_u))))
