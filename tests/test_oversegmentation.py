"""Over-segmentation solver tests on synthetic volumes."""

import numpy as np
import jax.numpy as jnp

from video_segment_tpu.core import oversegmentation as ov


def _labels_np(res):
    return np.asarray(res.label)


def _params(**kw):
    base = dict(min_region_size=1, schedule=(2, 32, 256, 2047),
                max_rounds_per_level=8, max_final_rounds=16)
    base.update(kw)
    return ov.OversegParams(**base)


def test_two_halves_merge():
    h, w = 8, 16
    vol = np.zeros((1, h, w, 3), np.float32)
    vol[:, :, w // 2:] = 0.8
    res = ov.oversegment(jnp.asarray(vol), params=_params())
    lab = _labels_np(res)[0]
    # Exactly two regions, split at the color boundary.
    assert len(np.unique(lab[:, : w // 2])) == 1
    assert len(np.unique(lab[:, w // 2:])) == 1
    assert lab[0, 0] != lab[0, -1]


def test_noise_tolerance_within_merge_threshold():
    rng = np.random.default_rng(1)
    h, w = 16, 16
    vol = np.full((1, h, w, 3), 0.5, np.float32)
    vol += rng.normal(0, 0.005, size=vol.shape).astype(np.float32)
    res = ov.oversegment(jnp.asarray(vol), params=_params())
    lab = _labels_np(res)[0]
    assert len(np.unique(lab)) == 1


def test_four_quadrants_distinct():
    h, w = 12, 12
    vol = np.zeros((1, h, w, 3), np.float32)
    vol[:, : h // 2, : w // 2] = 0.1
    vol[:, : h // 2, w // 2:] = 0.4
    vol[:, h // 2:, : w // 2] = 0.7
    vol[:, h // 2:, w // 2:] = 1.0
    res = ov.oversegment(jnp.asarray(vol), params=_params())
    lab = _labels_np(res)[0]
    assert len(np.unique(lab)) == 4


def test_min_region_size_forcing():
    h, w = 16, 16
    vol = np.zeros((1, h, w, 3), np.float32)
    vol[0, 7:9, 7:9] = 1.0  # 4-pixel speckle, strongly different
    res = ov.oversegment(jnp.asarray(vol), params=_params(min_region_size=8))
    lab = _labels_np(res)[0]
    # Speckle forced into surrounding region.
    assert len(np.unique(lab)) == 1


def test_temporal_coherence():
    t, h, w = 3, 8, 8
    vol = np.zeros((t, h, w, 3), np.float32)
    vol[:, :, w // 2:] = 0.9
    res = ov.oversegment(jnp.asarray(vol), params=_params())
    lab = _labels_np(res)
    # Regions span time: same label at a given side across frames.
    assert len(np.unique(lab[:, :, : w // 2])) == 1
    assert len(np.unique(lab[:, :, w // 2:])) == 1


def test_constraints_same_id_merges_and_survives():
    t, h, w = 2, 6, 8
    vol = np.zeros((t, h, w, 3), np.float32)
    vol[:, :, w // 2:] = 0.9
    constraints = np.full((t, h, w), -1, np.int32)
    constraints[0, :, : w // 2] = 0
    constraints[0, :, w // 2:] = 1
    res = ov.oversegment(jnp.asarray(vol),
                         constraints=jnp.asarray(constraints),
                         params=_params())
    lab = _labels_np(res)
    left_root = lab[1, 0, 0]
    right_root = lab[1, 0, -1]
    assert left_root != right_root
    constr, _ = ov.region_attrs(res, np.asarray([left_root, right_root]))
    assert constr[0] == 0
    assert constr[1] == 1


def test_constraints_different_ids_never_merge():
    # Uniform color but two different constraint ids in frame 0: the two
    # constrained groups must not merge with each other.
    t, h, w = 1, 4, 8
    vol = np.full((t, h, w, 3), 0.5, np.float32)
    constraints = np.full((t, h, w), -1, np.int32)
    constraints[0, :, : w // 2] = 0
    constraints[0, :, w // 2:] = 1
    res = ov.oversegment(jnp.asarray(vol),
                         constraints=jnp.asarray(constraints),
                         params=_params())
    lab = _labels_np(res)[0]
    assert lab[0, 0] != lab[0, -1]


def test_constraint_split_unconstrains():
    # Frame 0 constrained to one id, but colors split hard: the far side
    # (similar size) is unconstrained and becomes its own region.
    t, h, w = 1, 6, 12
    vol = np.zeros((t, h, w, 3), np.float32)
    vol[:, :, w // 2:] = 1.0
    constraints = np.full((t, h, w), 0, np.int32)
    res = ov.oversegment(jnp.asarray(vol),
                         constraints=jnp.asarray(constraints),
                         params=_params())
    lab = _labels_np(res)[0]
    assert lab[0, 0] != lab[0, -1]


def test_flow_displaced_temporal_edges():
    # A bright bar moves 3 px right between frames; with correct backward
    # flow the bar merges across time despite no spatial overlap... the bar
    # is 2 px wide so the undisplaced 9-neighborhood cannot reach it.
    t, h, w = 2, 8, 16
    vol = np.zeros((t, h, w, 3), np.float32)
    vol[0, :, 4:6] = 1.0
    vol[1, :, 9:11] = 1.0
    flow = np.zeros((1, h, w, 2), np.float32)
    flow[0, :, :, 0] = -5.0  # backward flow: current pixel was 5 px left
    res_nf = ov.oversegment(jnp.asarray(vol), params=_params())
    res_fl = ov.oversegment(jnp.asarray(vol), flow=jnp.asarray(flow),
                            params=_params())
    lab_nf = _labels_np(res_nf)
    lab_fl = _labels_np(res_fl)
    assert lab_nf[0, 0, 4] != lab_nf[1, 0, 9]      # disconnected without flow
    assert lab_fl[0, 0, 4] == lab_fl[1, 0, 9]      # connected along flow


def test_region_sizes_match():
    h, w = 8, 16
    vol = np.zeros((1, h, w, 3), np.float32)
    vol[:, :, w // 2:] = 0.8
    res = ov.oversegment(jnp.asarray(vol), params=_params())
    lab = _labels_np(res)[0]
    _, size = ov.region_attrs(res, np.asarray([lab[0, 0], lab[0, -1]]))
    assert size[0] == h * w // 2
    assert size[1] == h * w // 2


def test_color_mean_variance_trait_adaptive_gating():
    """Bhattacharyya trait (pixel_distance.h:566-638): the same mean gap
    merges under high variance (z-score small) but not under low variance.
    Regions are pre-seeded via init_label so variances are established
    (single pixels start at zero variance, like the reference's
    InitializeDescriptor)."""
    rng = np.random.default_rng(3)
    h, w = 16, 32
    init = np.zeros((1, h, w), np.int32)
    init[:, :, w // 2:] = w // 2  # two halves, canonical member voxels

    def run(noise_sigma):
        vol = np.zeros((1, h, w, 3), np.float32)
        vol[:, :, : w // 2] = 0.45
        vol[:, :, w // 2:] = 0.55
        vol += rng.normal(0, noise_sigma, vol.shape).astype(np.float32)
        vol = np.clip(vol, 0.0, 1.0)
        p = ov.OversegParams(min_region_size=1,
                             descriptor="color_mean_variance",
                             merge_threshold=0.1, split_threshold=0.75,
                             schedule=(64, 512, 2047))
        res = ov.oversegment(jnp.asarray(vol), init_label=jnp.asarray(init),
                             params=p)
        return len(np.unique(_labels_np(res)))

    # d = |dmean| / sqrt(pooled var) * 0.2: sigma 0.6 -> ~0.08 (merges),
    # sigma 0.03 -> ~0.5 (stays split).
    assert run(0.6) == 1
    assert run(0.03) == 2


def test_variance_trait_formula_oracle():
    import video_segment_tpu.core.oversegmentation as o
    mean_a = jnp.asarray([[0.5, 0.5, 0.5]])
    mean_b = jnp.asarray([[0.6, 0.5, 0.5]])
    var = jnp.asarray([[0.04, 0.04, 0.04]])
    p = ov.OversegParams(descriptor="color_mean_variance")
    d = np.asarray(o._trait_distance(mean_a, var, mean_b, var,
                                     jnp.zeros(1, jnp.int32), p))
    want = min(1.0, np.sqrt(0.01 / 0.04) * 0.2)
    np.testing.assert_allclose(d[0], want, atol=1e-6)


def test_edge_table_matches_pixel_solver_on_real_texture():
    """The v2 edge-table path tracks the v1 pixel path on a realistic
    textured clip (textured patches, pan, a moving object and noise: the
    order-inversion artifact class lives here; floor 0.85)."""
    from video_segment_tpu.dataio.synthetic import synthetic_clip
    from video_segment_tpu.ops import tile_preseg
    from video_segment_tpu.segment_util.metrics import boundary_f_measure

    frames = synthetic_clip(64, 48, 4, seed=0)
    vol = jnp.asarray(frames, jnp.float32) / 255.0

    p1 = ov.OversegParams(min_region_size=12, edge_table=False,
                          compact_after_levels=1)
    p2 = ov.OversegParams(min_region_size=12, edge_table=True,
                          table_divisor=2, preseg_threshold=0.01)
    init = tile_preseg.tile_presegment(vol, 0.01, "l2")
    r1 = np.asarray(ov.oversegment(vol, params=p1).label)
    r2 = np.asarray(ov.oversegment(vol, init_label=init, params=p2).label)
    m = boundary_f_measure(r1, r2, tolerance=1)
    assert m["f_measure"] >= 0.85, m


def test_mid_schedule_recompaction_preserves_partition(monkeypatch):
    """Shrinking-phase recompaction (_recompact_table) must reproduce the
    single-phase partition on structured content.  Phase constants are
    patched small so a 16x32x3-frame volume crosses two phase boundaries
    (production sizes recompact 98k -> 32k tables)."""
    rng = np.random.default_rng(7)
    t, h, w = 3, 16, 32
    vol = np.zeros((t, h, w, 3), np.float32)
    vol[:, :, : w // 2] = 0.2
    vol[:, :, w // 2:] = 0.8
    vol[:, h // 2:, : w // 2] = 0.5
    vol += rng.normal(0, 0.004, size=vol.shape).astype(np.float32)
    volj = jnp.asarray(vol)
    params = _params(min_region_size=8)

    ref = _labels_np(ov.oversegment(volj, params=params))

    monkeypatch.setattr(ov, "_PHASE_Q", 256)
    monkeypatch.setattr(ov, "_PHASE_FLOOR", 256)
    caps = ov._table_phase_caps(
        ov._table_cap(params, t * h * w, h, w, False) + 1)
    assert len(caps) >= 2, caps  # the patched solve really recompacts
    got = _labels_np(ov.oversegment(volj, params=params))

    # Partition equality up to relabeling.
    ids_a, inv_a = np.unique(ref, return_inverse=True)
    ids_b, inv_b = np.unique(got, return_inverse=True)
    assert len(ids_a) == len(ids_b)
    pair = inv_a.astype(np.int64) * len(ids_b) + inv_b
    assert len(np.unique(pair)) == len(ids_a)


def test_finalize_level_gates_by_bucket():
    """Finalization carries the failing edge's bucket, not a blanket flag
    (segmentation_graph.h:399-402 under ascending edge order): a region
    finalized at level L still merges across an edge of bucket < L (the
    sequential reference would have processed that edge first), while
    level 0 blocks everything.  This is what dissolves preseg tile seams
    in smooth areas."""
    t, h, w = 1, 16, 256
    vol = jnp.full((t, h, w, 3), 0.3, jnp.float32)
    init = np.zeros((t, h, w), np.int32)
    init[:, :, 128:] = 128      # two same-color halves, seeded separately
    params = ov.OversegParams(edge_table=True, table_slots=1024,
                              min_region_size=1)
    for fin_level, want in ((50, 1), (0, 2)):
        fin = jnp.full((t, h, w), fin_level, jnp.int32)
        res = ov.oversegment(vol, init_label=jnp.asarray(init), fin=fin,
                             params=params)
        assert len(np.unique(np.asarray(res.label))) == want, fin_level


def test_fin_every_round_valid_covering():
    """Per-round failure scans (fin_every_round) freeze a region as soon
    as a merge test fails, mirroring the reference's per-edge finalization
    in strict ascending bucket order (segmentation_graph.h:383-402).  The
    output must stay a full covering, be at least as fine as the
    level-end-only scan on contrasty content, and agree exactly with it
    on clean piecewise-constant input (no admissible test ever fails
    there, so the extra scans are no-ops)."""
    h, w = 12, 12
    flat = np.zeros((1, h, w, 3), np.float32)
    flat[:, : h // 2] = 0.9
    rng = np.random.default_rng(3)
    noisy = rng.uniform(0, 1, size=(2, h, w, 3)).astype(np.float32)
    for vol, exact in ((flat, True), (noisy, False)):
        labs = {}
        for fer in (False, True):
            res = ov.oversegment(jnp.asarray(vol),
                                 params=_params(fin_every_round=fer))
            lab = _labels_np(res)
            assert lab.shape == vol.shape[:3]
            labs[fer] = lab
        n_off = len(np.unique(labs[False]))
        n_on = len(np.unique(labs[True]))
        assert n_on >= n_off, (n_on, n_off)
        if exact:
            assert n_on == n_off == 2


def test_min_size_interleave_forces_early():
    """Interleaved min-size rounds absorb sub-min-size fragments along
    edges the current schedule level has reached (segmentation_graph.h:
    407-415 in-traversal forcing); output stays a full covering with no
    sub-min-size survivors that have mergeable neighbors."""
    rng = np.random.default_rng(7)
    h, w = 16, 24
    vol = np.full((2, h, w, 3), 0.5, np.float32)
    # Speckle of strongly-contrasting single pixels inside a flat field:
    # each becomes a tiny region that only min-size forcing can remove.
    ys, xs = rng.integers(2, h - 2, 12), rng.integers(2, w - 2, 12)
    vol[:, ys, xs] = 0.95
    for inter in (0, 2):
        res = ov.oversegment(jnp.asarray(vol), params=_params(
            min_region_size=8, min_size_interleave=inter))
        lab = _labels_np(res)
        assert lab.shape == (2, h, w)
        _, counts = np.unique(lab, return_counts=True)
        assert counts.min() >= 8, (inter, counts.min())


def test_pair_merge_equivalent_partitions():
    """Depth-1 hooking (pair_merge) converges to the same partition on
    clean synthetic content (chains only matter where means drift, i.e.
    texture) and always yields a valid full labeling."""
    rng = np.random.default_rng(7)
    h, w = 16, 32
    vol = np.zeros((2, h, w, 3), np.float32)
    vol[:, :, w // 2:] = 0.8
    vol += rng.normal(0, 0.004, size=vol.shape).astype(np.float32)
    res = ov.oversegment(jnp.asarray(vol), params=_params(pair_merge=True))
    lab = _labels_np(res)
    assert len(np.unique(lab[:, :, : w // 2])) == 1
    assert len(np.unique(lab[:, :, w // 2:])) == 1
    assert lab[0, 0, 0] != lab[0, 0, -1]


def test_pair_merge_min_size_forcing_unaffected():
    rng = np.random.default_rng(3)
    h, w = 16, 16
    vol = rng.uniform(0, 1, size=(1, h, w, 3)).astype(np.float32)
    res = ov.oversegment(jnp.asarray(vol),
                         params=_params(min_region_size=8, pair_merge=True))
    lab = _labels_np(res)[0]
    _, counts = np.unique(lab, return_counts=True)
    assert counts.min() >= 8
