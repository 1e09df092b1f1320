"""Tile-local Felzenszwalb pre-solve (Stage A of the v2 over-segmenter).

Runs the full bucket-schedule merge semantics of the reference
(segmentation_graph.h:339-463: ascending weight levels, mean-color
descriptor gate, finalize-on-failed-test) *locally* inside (8,128)
tiles, one frame at a time, so the global edge-table solver starts from
~10-100x fewer regions than raw pixels.  Cross-tile, temporal, constraint,
and min-region-size semantics are NOT handled here — they belong to the
global phases.  The tile decides which pixels may merge here, and the
solver's quality defaults were tuned on it.

Every tile is solved independently in plain jnp, vmapped over all tiles
of the volume; the level/round loop runs once for the whole batch.  A
tile label is a (row, col) pair (labr in [0,8), labc in [0,128)), so
label tables are (8,128)-shaped like the tile:

- aggregate(v)[a,b]   = sum of v over pixels with label (a,b): one
  dot_general against the column one-hot, batched over pixel rows.  A
  contraction, not a scatter-add, so the float sums come out in the same
  order on every run;
- distribute(T)[i,j]  = T[labr[i,j], labc[i,j]]: a gather;
- per-label min: a segment min (exact in any order).

The contractions ask for Precision.HIGHEST: on the GPU a float32 dot may
otherwise run in TF32, and region color sums would lose about three
digits.

The pure-NumPy mirror `tile_felz_reference` implements the identical
round structure; tests assert exact label equality.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.ops import cc

TILE_H = 8
TILE_W = 128
NUM_BUCKETS = 2048
_BIG = 2 ** 30
_HIGHEST = jax.lax.Precision.HIGHEST

# In-tile N8 directions as (dy, dx); every edge is proposed from both ends.
DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def _roll2(x, dy, dx):
    """Neighbor view: value at (i+dy, j+dx), non-wrapping handled by masks."""
    return jnp.roll(x, (-dy, -dx), axis=(0, 1))


def _onehot_cols(labc):
    """(8,128) int32 col labels -> (8,128,128) bool one-hot over columns.

    Sums run as per-label-ROW slices against this column one-hot, so the
    large intermediates are (8,128,128) and not (1024,1024)."""
    b = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W, TILE_W), 2)
    return labc[:, :, None] == b


def _aggregate_many(labr, ohc_f, vs):
    """Sum each of K value planes v (8,128) into a label table (8,128):
    T[a,b] = sum over pixels with label (a,b).  lhs[i,a,j] = v[i,j] masked
    to label row a; ONE dot against the column one-hot, batched over pixel
    rows i and contracting j, then a sum over i."""
    k = len(vs)
    a3 = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_H, TILE_W), 1)
    mask = labr[:, None, :] == a3                       # (i, a, j)
    lhs = jnp.concatenate(
        [jnp.where(mask, v[:, None, :], 0.0) for v in vs], axis=1)
    out = jax.lax.dot_general(lhs, ohc_f, (((2,), (1,)), ((0,), (0,))),
                              precision=_HIGHEST,
                              preferred_element_type=jnp.float32)
    out = jnp.sum(out, axis=0)                          # (k*8, 128)
    return [out[i * TILE_H:(i + 1) * TILE_H] for i in range(k)]


def _distribute(labr, labc, table):
    """Per-pixel value of its label: g[i,j] = table[labr[i,j], labc[i,j]]
    (a gather, exact for any value)."""
    return _distribute_many(labr, labc, [table])[0]


def _distribute_many(labr, labc, tables):
    """Fused _distribute of K tables (one gather)."""
    stk = jnp.stack(tables).reshape(len(tables), TILE_H * TILE_W)
    g = stk[:, labr * TILE_W + labc]
    return [g[i] for i in range(len(tables))]


def _label_min(labr, labc, v):
    """Per-label min of v as an (8,128) table; labels that own no pixel
    hold the dtype's largest value."""
    return jax.ops.segment_min(v.reshape(-1), (labr * TILE_W + labc)
                               .reshape(-1), num_segments=TILE_H * TILE_W,
                               indices_are_sorted=False) \
        .reshape(TILE_H, TILE_W)


def _compose(pa, pb):
    """One pointer-jump of the (row,col) parent tables: P <- P[P]."""
    return tuple(_distribute_many(pa, pb, [pa, pb]))


def _dist(a, b, metric):
    d0 = a[0] - b[0]
    d1 = a[1] - b[1]
    d2 = a[2] - b[2]
    if metric == "l1":
        return (jnp.abs(d0) + jnp.abs(d1) + jnp.abs(d2)) * (1.0 / 3.0)
    return jnp.sqrt((d0 * d0 + d1 * d1 + d2 * d2) * (1.0 / 3.0))


def _tile_edges(color3, y0, x0, h, w, metric):
    """Static per-direction edge buckets + validity of one tile whose
    top-left pixel is (y0, x0) in the (h, w) frame."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 1)
    inb = (y0 + rows < h) & (x0 + cols < w)
    c = [color3[:, :, 0], color3[:, :, 1], color3[:, :, 2]]
    buckets = []
    valids = []
    for dy, dx in DIRS:
        nb = [_roll2(ch, dy, dx) for ch in c]
        d = _dist(c, nb, metric)
        bkt = jnp.clip((d * NUM_BUCKETS).astype(jnp.int32), 0,
                       NUM_BUCKETS - 1)
        nb_inb = _roll2(inb, dy, dx)
        v = (inb & nb_inb
             & (rows + dy >= 0) & (rows + dy < TILE_H)
             & (cols + dx >= 0) & (cols + dx < TILE_W))
        buckets.append(bkt)
        valids.append(v)
    return c, buckets, valids


def _solve_tiles(color, y0, x0, h, w, *, schedule, rounds_per_level,
                 merge_threshold, metric, fin_margin,
                 fin_eager=False, fin_gated=False, pair_merge=False):
    """Full local solve of a batch of (8,128) tiles: color (N,8,128,3),
    tile origins y0/x0 (N,).  Returns per tile the flat local root label
    (8,128) int32 in [0,1024), the per-pixel fin level (8,128) f32, and
    the cell-positioned region size and color-sum tables.

    The level/round iteration runs as ONE lax.fori_loop over the whole
    batch (merge round or level end, chosen by lax.cond outside the vmap
    so only the taken branch runs): iteration i decodes to (theta, merge
    or level end, round parity) from a static table."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 1)
    tiles = jax.vmap(functools.partial(_tile_edges, h=h, w=w,
                                       metric=metric))(color, y0, x0)

    n_levels = len(schedule)
    rounds = ((rounds_per_level,) * n_levels
              if isinstance(rounds_per_level, int)
              else tuple(rounds_per_level))
    if len(rounds) != n_levels:
        raise ValueError(f"rounds_per_level {rounds} does not match "
                         f"schedule {schedule}")

    def region_views(c, labr, labc, ohc_f):
        """Per-pixel region means (fused aggregate + distribute)."""
        ones = jnp.ones((TILE_H, TILE_W), jnp.float32)
        size_t, s0, s1, s2 = _aggregate_many(labr, ohc_f, [ones] + c)
        den = jnp.maximum(size_t, 1.0)
        return _distribute_many(labr, labc, [s0 / den, s1 / den, s2 / den])

    def merge_round(tile, labr, labc, fin_t, fin_x, theta, rnd):
        c, buckets, valids = tile
        ohc_f = _onehot_cols(labc).astype(jnp.float32)
        ones = jnp.ones((TILE_H, TILE_W), jnp.float32)
        size_t, s0, s1, s2 = _aggregate_many(labr, ohc_f, [ones] + c)
        den = jnp.maximum(size_t, 1.0)
        mean_px0 = _distribute_many(labr, labc,
                                    [s0 / den, s1 / den, s2 / den, fin_t])
        mean_px, fin_px = mean_px0[:3], mean_px0[3]   # f32 finalize level
        lab_flat = labr * TILE_W + labc
        best = jnp.full((TILE_H, TILE_W), _BIG, jnp.int32)
        fbig = jnp.float32(float(_BIG))
        fail = jnp.full((TILE_H, TILE_W), fbig, jnp.float32)
        strong = jnp.full((TILE_H, TILE_W), fbig, jnp.float32)
        for k, (dy, dx) in enumerate(DIRS):
            nb_mean = [_roll2(m, dy, dx) for m in mean_px]
            nb_fin = _roll2(fin_px, dy, dx)
            nb_lab = _roll2(lab_flat, dy, dx)
            dd = _dist(mean_px, nb_mean, metric)
            adm = (valids[k] & (buckets[k] <= theta)
                   & (nb_lab != lab_flat)
                   & (buckets[k] < fin_px) & (buckets[k] < nb_fin)
                   & (dd < merge_threshold))
            cand = (buckets[k] << 10) | nb_lab
            best = jnp.minimum(best, jnp.where(adm, cand, _BIG))
            if fin_eager:
                # Eager finalization (one-round lag): a failed merge test
                # freezes both endpoints at the failing bucket before the
                # NEXT round instead of only at level end — the ascending
                # per-edge order of segmentation_graph.h:383-402, where the
                # first failure stops a region's growth immediately.  Gated
                # like the reference's test (only edges between two not-yet-
                # finalized regions count as tests).
                bk = buckets[k].astype(jnp.float32)
                act = (valids[k] & (buckets[k] <= theta)
                       & (nb_lab != lab_flat)
                       & (bk < fin_px) & (bk < nb_fin))
                fail = jnp.minimum(
                    fail, jnp.where(act & (dd >= merge_threshold), bk, fbig))
                strong = jnp.minimum(
                    strong,
                    jnp.where(act & (dd >= merge_threshold * fin_margin),
                              bk, fbig))
        if fin_eager:
            # Fold the existing tables through the aggregation (cell a's
            # pixel carries label b after an a->b hook, so aggregating the
            # table AS a pixel plane transfers orphaned fins to the root).
            fin_t = _label_min(labr, labc, jnp.minimum(fail, fin_t))
            fin_x = _label_min(labr, labc, jnp.minimum(strong, fin_x))

        best_t = _label_min(labr, labc, best)
        partner = best_t & 1023
        have = best_t < _BIG
        own_flat = rows * TILE_W + cols           # table cell's own label id
        up = (rnd % 2) == 0
        hook = have & ((partner > own_flat) == up)
        if pair_merge:
            # Depth-1 hooking: cancel hooks whose target also hooks this
            # round, so every merge is tested against the target's CURRENT
            # mean instead of collapsing a->b->c chains through b's stale
            # one (the reference re-evaluates after every single merge,
            # segmentation_graph.h:339-463).  The chain end's hook always
            # survives, so progress is guaranteed.
            pa_t = partner >> 7
            pb_t = partner & 127
            hook = hook & ~_distribute(pa_t, pb_t, hook)
        pa = jnp.where(hook, partner >> 7, rows)
        pb = jnp.where(hook, partner & 127, cols)
        # Parity hooking chains are monotone; one jump resolves <=2 deep.
        # Deeper chains leave stale labels that simply re-merge next round
        # (and the caller's final pointer_jump resolves any residue).
        pa, pb = _compose(pa, pb)
        labr2, labc = _distribute_many(labr, labc, [pa, pb])
        return labr2, labc, fin_t, fin_x

    def level_end(tile, labr, labc, fin_t, fin_x, theta):
        c, buckets, valids = tile
        # A failed merge test finalizes both endpoint regions FROM THE
        # FAILING EDGE'S WEIGHT UP (segmentation_graph.h:399-402 processes
        # edges in ascending order, so "finalized forever" there means
        # "no merges at weight >= the failing edge's weight"): fin tables
        # record the minimum failing bucket, and merge admissibility is
        # bucket < fin.  A blanket flag would also block near-zero-weight
        # edges the sequential reference would have merged long before the
        # failure — across tile seams that preserved the 8x128 grid in
        # smooth areas.  The EXPORTED level (fin_x) only counts strong
        # failures (dd >= margin * threshold): borderline tile-local
        # failures often dissolve once the global phase sees whole-region
        # means (round-3 sweep).
        ohc_f = _onehot_cols(labc).astype(jnp.float32)
        mean_px = region_views(c, labr, labc, ohc_f)
        lab_flat = labr * TILE_W + labc
        fin_px = _distribute(labr, labc, fin_t) if fin_gated else None
        fail = jnp.full((TILE_H, TILE_W), _BIG, jnp.int32)
        strong = jnp.full((TILE_H, TILE_W), _BIG, jnp.int32)
        for k, (dy, dx) in enumerate(DIRS):
            nb_mean = [_roll2(m, dy, dx) for m in mean_px]
            nb_lab = _roll2(lab_flat, dy, dx)
            dd = _dist(mean_px, nb_mean, metric)
            act = (valids[k] & (buckets[k] <= theta)
                   & (nb_lab != lab_flat))
            if fin_gated:
                # Reference test gate (segmentation_graph.h:388): only
                # edges between two not-yet-finalized regions are tested,
                # so an edge to an already-finalized neighbor cannot
                # finalize this region.
                bk = buckets[k].astype(jnp.float32)
                nb_fin = _roll2(fin_px, dy, dx)
                act = act & (bk < fin_px) & (bk < nb_fin)
            bad = act & (dd >= merge_threshold)
            fail = jnp.minimum(fail, jnp.where(bad, buckets[k], _BIG))
            strong = jnp.minimum(
                strong,
                jnp.where(act & (dd >= merge_threshold * fin_margin),
                          buckets[k], _BIG))
        fail_f = fail.astype(jnp.float32)
        strong_f = strong.astype(jnp.float32)
        if fin_eager:
            # Transfer orphaned fins of merged-away roots (see merge_round).
            fail_f = jnp.minimum(fail_f, fin_t)
            strong_f = jnp.minimum(strong_f, fin_x)
            fin_t = _label_min(labr, labc, fail_f)
            fin_x = _label_min(labr, labc, strong_f)
        else:
            fin_t = jnp.minimum(fin_t, _label_min(labr, labc, fail_f))
            fin_x = jnp.minimum(fin_x, _label_min(labr, labc, strong_f))
        return labr, labc, fin_t, fin_x

    # Per-iteration (theta, is_merge, round parity): a per-LEVEL round
    # count (rounds may be a tuple, e.g. many depth-1 rounds at low thetas
    # where convergence is safe, few at the texture-forming levels)
    # without a ragged loop structure.
    iters = np.array([(th, ph < rounds[lv], ph)
                      for lv, th in enumerate(schedule)
                      for ph in range(rounds[lv] + 1)], np.int32)
    merge_v = jax.vmap(merge_round, in_axes=(0, 0, 0, 0, 0, None, None))
    level_end_v = jax.vmap(level_end, in_axes=(0, 0, 0, 0, 0, None))

    def body(i, carry):
        it = jnp.asarray(iters)[i]
        theta, rnd = it[0], it[2]
        return jax.lax.cond(
            it[1] > 0,
            lambda s: merge_v(tiles, *s, theta, rnd),
            lambda s: level_end_v(tiles, *s, theta),
            carry)

    n = color.shape[0]
    open_f = jnp.full((n, TILE_H, TILE_W), float(_BIG), jnp.float32)
    state = (jnp.broadcast_to(rows, (n, TILE_H, TILE_W)),
             jnp.broadcast_to(cols, (n, TILE_H, TILE_W)), open_f, open_f)
    labr, labc, _, fin_x = jax.lax.fori_loop(0, len(iters), body, state)
    return jax.vmap(_export)(tiles[0], labr, labc, fin_x)


def _export(c, labr, labc, fin_x):
    """Resolve residual label chains of one tile, then export its labels,
    fin levels and cell-positioned region statistics."""
    # Resolve residual label chains to a fixed point, min-propagating the
    # fin table along the pointer graph as labels jump: fins (and the
    # stats below) recorded at a STALE chain root would otherwise be
    # orphaned when its pixels re-point to the true root.
    def jcond(carry):
        return carry[3]

    def jbody(carry):
        labr, labc, finx, _ = carry
        finx2 = _label_min(labr, labc, finx)
        nr, nc = _distribute_many(labr, labc, [labr, labc])
        chg = jnp.any((nr != labr) | (nc != labc))
        return nr, nc, finx2, chg

    labr, labc, fin_x, _ = jax.lax.while_loop(
        jcond, jbody, (labr, labc, fin_x, jnp.bool_(True)))

    # Final per-region statistics, exported CELL-POSITIONED (value lives at
    # the pixel position of its region's root cell): the global solver's
    # init then gathers per-slot stats from O(regions) cells instead of
    # segment-summing O(pixels).
    ohc_f = _onehot_cols(labc).astype(jnp.float32)
    fin_px = _distribute(labr, labc, fin_x)
    ones = jnp.ones((TILE_H, TILE_W), jnp.float32)
    size_t, *csum_t = _aggregate_many(labr, ohc_f, [ones] + c)
    return labr * TILE_W + labc, fin_px, size_t, csum_t


@functools.partial(jax.jit,
                   static_argnames=("schedule", "rounds_per_level",
                                    "merge_threshold", "metric",
                                    "fin_margin", "fin_eager", "fin_gated",
                                    "pair_merge"))
def tile_felzenszwalb(vol: jnp.ndarray,
                      schedule: tuple = (4, 32, 192, 1024),
                      rounds_per_level: int | tuple = 2,
                      merge_threshold: float = 0.05,
                      metric: str = "l2",
                      fin_margin: float = 1.0,
                      fin_eager: bool = False,
                      fin_gated: bool = False,
                      pair_merge: bool = False):
    """(T,H,W,3) float volume -> (labels, fin, (size, c0, c1, c2)).

    `stats` are CELL-POSITIONED per-region statistics ((T,H,W) f32 each):
    the voxel count and per-channel color sums of each region, stored at
    the pixel position of the region's root cell (0 elsewhere) — the
    global solver's table init gathers these instead of re-reducing
    pixels.  Labels are global voxel ids of in-tile roots
    (self-rooted).  `fin` is
    the finalize LEVEL of each pixel's local region: the minimum bucket at
    which a strong merge test failed (NUM_BUCKETS = never failed).  The
    global solver admits merges only at bucket < fin — the ascending-order
    meaning of the reference's finalization (segmentation_graph.h:399-402):
    a blanket "finalized" flag would also block the near-zero-weight edges
    the sequential reference merges long before any failure, which is what
    preserved 8x128 tile seams in smooth areas.
    """
    t, h, w, _ = vol.shape
    ny = -(-h // TILE_H)
    nx = -(-w // TILE_W)
    hp, wp = ny * TILE_H, nx * TILE_W
    volp = jnp.pad(vol, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)),
                   constant_values=1e6)
    color = volp.reshape(t, ny, TILE_H, nx, TILE_W, 3) \
        .transpose(0, 1, 3, 2, 4, 5).reshape(-1, TILE_H, TILE_W, 3)
    ti, yi, xi = (a.reshape(-1) for a in jnp.meshgrid(
        jnp.arange(t, dtype=jnp.int32), jnp.arange(ny, dtype=jnp.int32),
        jnp.arange(nx, dtype=jnp.int32), indexing="ij"))
    y0 = yi * TILE_H
    x0 = xi * TILE_W
    lab, fin, size_t, csum_t = _solve_tiles(
        color, y0, x0, h, w, schedule=schedule,
        rounds_per_level=rounds_per_level, merge_threshold=merge_threshold,
        metric=metric, fin_margin=fin_margin, fin_eager=fin_eager,
        fin_gated=fin_gated, pair_merge=pair_merge)
    # local root -> global voxel id
    root_y = y0[:, None, None] + (lab >> 7)
    root_x = x0[:, None, None] + (lab & 127)
    out = ti[:, None, None] * (h * w) + root_y * w + root_x
    # Finalize level, NUM_BUCKETS == never finalized (open).
    fin = jnp.minimum(fin, float(NUM_BUCKETS)).astype(jnp.int32)

    def untile(x):
        return x.reshape(t, ny, nx, TILE_H, TILE_W) \
            .transpose(0, 1, 3, 2, 4).reshape(t, hp, wp)[:, :h, :w]

    out = untile(out)
    stats = (untile(size_t),) + tuple(untile(x) for x in csum_t)
    # Labels are self-rooted by construction (the root cell's own label is
    # itself after full pointer jumping), but pointer-jump defensively —
    # it exits after one no-change iteration.
    return (cc.pointer_jump(out.reshape(-1)).reshape(out.shape),
            untile(fin), stats)


# ---------------------------------------------------------------------------
# NumPy mirror (same round structure; used as the test oracle).


def tile_felz_reference(vol: np.ndarray, schedule=(4, 32, 192, 1024),
                        rounds_per_level: int = 2,
                        merge_threshold: float = 0.05,
                        metric: str = "l2",
                        fin_margin: float = 1.0,
                        fin_eager: bool = False,
                        fin_gated: bool = False,
                        pair_merge: bool = False):
    """Sequential NumPy mirror of the kernel, tile by tile."""
    t, h, w, _ = vol.shape
    out = np.zeros((t, h, w), np.int64)
    fin_out = np.zeros((t, h, w), np.int64)
    size_out = np.zeros((t, h, w), np.float32)
    csum_out = np.zeros((t, h, w, 3), np.float32)
    for ti in range(t):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, w, TILE_W):
                hh = min(TILE_H, h - y0)
                ww = min(TILE_W, w - x0)
                pad = np.full((TILE_H, TILE_W, 3), 1e6, np.float32)
                pad[:hh, :ww] = vol[ti, y0:y0 + hh, x0:x0 + ww]
                lab, fin = _ref_subtile(pad, hh, ww, schedule,
                                        rounds_per_level, merge_threshold,
                                        metric, fin_margin,
                                        fin_eager=fin_eager,
                                        fin_gated=fin_gated,
                                        pair_merge=pair_merge)
                ry, rx = lab[:hh, :ww] // TILE_W, lab[:hh, :ww] % TILE_W
                out[ti, y0:y0 + hh, x0:x0 + ww] = \
                    ti * h * w + (y0 + ry) * w + (x0 + rx)
                fin_out[ti, y0:y0 + hh, x0:x0 + ww] = fin[:hh, :ww]
                # Cell-positioned region stats over valid pixels.
                lv = lab[:hh, :ww].ravel()
                sz = np.zeros(TILE_H * TILE_W, np.float32)
                cs = np.zeros((TILE_H * TILE_W, 3), np.float32)
                np.add.at(sz, lv, 1.0)
                np.add.at(cs, lv, pad[:hh, :ww].reshape(-1, 3))
                cells = np.flatnonzero(sz > 0)
                cy, cx = cells // TILE_W, cells % TILE_W
                size_out[ti, y0 + cy, x0 + cx] = sz[cells]
                csum_out[ti, y0 + cy, x0 + cx] = cs[cells]
    return out, fin_out, (size_out, csum_out[..., 0], csum_out[..., 1],
                          csum_out[..., 2])


def _ref_subtile(c, hh, ww, schedule, rounds_per_level, merge_threshold,
                 metric, fin_margin=1.0, fin_eager=False, fin_gated=False,
                 pair_merge=False):
    def dist(a, b):
        d = a - b
        if metric == "l1":
            return np.abs(d).sum(-1) / 3.0
        return np.sqrt((d * d).sum(-1) / 3.0)

    rows, cols = np.mgrid[0:TILE_H, 0:TILE_W]
    inb = (rows < hh) & (cols < ww)
    lab = (rows * TILE_W + cols).astype(np.int64)

    buckets = {}
    valids = {}
    for dy, dx in DIRS:
        nb = np.roll(np.roll(c, -dy, axis=0), -dx, axis=1)
        bkt = np.clip((dist(c, nb) * NUM_BUCKETS).astype(np.int64), 0,
                      NUM_BUCKETS - 1)
        nb_inb = np.roll(np.roll(inb, -dy, axis=0), -dx, axis=1)
        v = (inb & nb_inb & (rows + dy >= 0) & (rows + dy < TILE_H)
             & (cols + dx >= 0) & (cols + dx < TILE_W))
        buckets[(dy, dx)] = bkt
        valids[(dy, dx)] = v

    BIG = 2 ** 30
    fin = np.full(TILE_H * TILE_W, BIG, np.int64)    # finalize level
    fin_x = np.full(TILE_H * TILE_W, BIG, np.int64)  # exported (strong)

    def tables():
        csum = np.zeros((TILE_H * TILE_W, 3))
        size = np.zeros(TILE_H * TILE_W)
        np.add.at(csum, lab.ravel(), c.reshape(-1, 3))
        np.add.at(size, lab.ravel(), 1.0)
        return csum / np.maximum(size, 1.0)[:, None]

    rounds = ((rounds_per_level,) * len(schedule)
              if isinstance(rounds_per_level, int)
              else tuple(rounds_per_level))
    for lvl_i, theta in enumerate(schedule):
        for rnd in range(rounds[lvl_i]):
            mean = tables()
            mean_px = mean[lab]
            fin_px = fin[lab]
            best = np.full((TILE_H, TILE_W), BIG, np.int64)
            for dy, dx in DIRS:
                nb_lab = np.roll(np.roll(lab, -dy, axis=0), -dx, axis=1)
                nb_mean = np.roll(np.roll(mean_px, -dy, axis=0), -dx, axis=1)
                nb_fin = np.roll(np.roll(fin_px, -dy, axis=0), -dx, axis=1)
                dd = dist(mean_px, nb_mean)
                bkt = buckets[(dy, dx)]
                adm = (valids[(dy, dx)] & (bkt <= theta)
                       & (nb_lab != lab) & (bkt < fin_px) & (bkt < nb_fin)
                       & (dd < merge_threshold))
                cand = (bkt << 10) | nb_lab
                best = np.minimum(best, np.where(adm, cand, BIG))
            if fin_eager:
                fail = np.full((TILE_H, TILE_W), BIG, np.int64)
                strong = np.full((TILE_H, TILE_W), BIG, np.int64)
                for dy, dx in DIRS:
                    nb_lab = np.roll(np.roll(lab, -dy, axis=0), -dx, axis=1)
                    nb_mean = np.roll(np.roll(mean_px, -dy, axis=0), -dx,
                                      axis=1)
                    nb_fin = np.roll(np.roll(fin_px, -dy, axis=0), -dx,
                                     axis=1)
                    dd = dist(mean_px, nb_mean)
                    bkt = buckets[(dy, dx)]
                    act = (valids[(dy, dx)] & (bkt <= theta)
                           & (nb_lab != lab)
                           & (bkt < fin_px) & (bkt < nb_fin))
                    fail = np.minimum(
                        fail, np.where(act & (dd >= merge_threshold),
                                       bkt, BIG))
                    strong = np.minimum(
                        strong,
                        np.where(act & (dd >= merge_threshold * fin_margin),
                                 bkt, BIG))
                f2 = np.full(TILE_H * TILE_W, 2 ** 31, np.int64)
                np.minimum.at(
                    f2, lab.ravel(),
                    np.minimum(fail,
                               fin.reshape(TILE_H, TILE_W)).ravel())
                fin = f2
                s2 = np.full(TILE_H * TILE_W, 2 ** 31, np.int64)
                np.minimum.at(
                    s2, lab.ravel(),
                    np.minimum(strong,
                               fin_x.reshape(TILE_H, TILE_W)).ravel())
                fin_x = s2
            best_t = np.full(TILE_H * TILE_W, BIG, np.int64)
            np.minimum.at(best_t, lab.ravel(), best.ravel())
            partner = best_t & 1023
            have = best_t < BIG
            own = np.arange(TILE_H * TILE_W)
            up = (rnd % 2) == 0
            hook = have & ((partner > own) == up)
            if pair_merge:
                # Depth-1 hooking (see the kernel's merge_round).
                hook = hook & ~hook[partner]
            parent = np.where(hook, partner, own)
            parent = parent[parent]
            lab = parent[lab]

        mean = tables()
        mean_px = mean[lab]
        fin_px = fin[lab]
        fail = np.full((TILE_H, TILE_W), BIG, np.int64)
        strong = np.full((TILE_H, TILE_W), BIG, np.int64)
        for dy, dx in DIRS:
            nb_lab = np.roll(np.roll(lab, -dy, axis=0), -dx, axis=1)
            nb_mean = np.roll(np.roll(mean_px, -dy, axis=0), -dx, axis=1)
            dd = dist(mean_px, nb_mean)
            bkt = buckets[(dy, dx)]
            act = (valids[(dy, dx)] & (bkt <= theta) & (nb_lab != lab))
            if fin_gated:
                nb_fin = np.roll(np.roll(fin_px, -dy, axis=0), -dx, axis=1)
                act = act & (bkt < fin_px) & (bkt < nb_fin)
            fail = np.minimum(fail,
                              np.where(act & (dd >= merge_threshold),
                                       bkt, BIG))
            strong = np.minimum(
                strong,
                np.where(act & (dd >= merge_threshold * fin_margin),
                         bkt, BIG))
        if fin_eager:
            fail_t = np.full(TILE_H * TILE_W, 2 ** 31, np.int64)
            np.minimum.at(
                fail_t, lab.ravel(),
                np.minimum(fail, fin.reshape(TILE_H, TILE_W)).ravel())
            fin = fail_t
            strong_t = np.full(TILE_H * TILE_W, 2 ** 31, np.int64)
            np.minimum.at(
                strong_t, lab.ravel(),
                np.minimum(strong, fin_x.reshape(TILE_H, TILE_W)).ravel())
            fin_x = strong_t
        else:
            fail_t = np.full(TILE_H * TILE_W, BIG, np.int64)
            np.minimum.at(fail_t, lab.ravel(), fail.ravel())
            fin = np.minimum(fin, fail_t)
            strong_t = np.full(TILE_H * TILE_W, BIG, np.int64)
            np.minimum.at(strong_t, lab.ravel(), strong.ravel())
            fin_x = np.minimum(fin_x, strong_t)

    # Resolve residual label chains, min-propagating fins along the
    # pointer graph exactly as the kernel's export loop does (fins at a
    # stale chain root would otherwise be orphaned by the jump).
    flat = lab.ravel().copy()
    while True:
        f2 = np.full(TILE_H * TILE_W, 2 ** 31, np.int64)
        np.minimum.at(f2, flat, fin_x)
        fin_x = f2
        nf = flat[flat]
        done = (nf == flat).all()
        flat = nf
        if done:
            break
    lab = flat.reshape(lab.shape)
    return lab, np.minimum(fin_x, NUM_BUCKETS)[lab]
