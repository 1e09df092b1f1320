"""Over-segmentation solver: bucketized parallel region merging.

Replaces the reference's sequential Felzenszwalb-style bucket-sweep
union-find (segmentation_graph.h:339-463, dense_segmentation_graph.h) with a
data-parallel formulation:

- The ascending-weight edge sweep becomes an ascending *bucket threshold
  schedule*: level k examines only edges whose 2048-bucket discretized weight
  (segmentation.h:90, dense_segmentation_graph.h:296-299) is <= theta_k.
- Within a level, Boruvka-style rounds run to a fixed point: every region
  selects its minimum-weight admissible incident edge (via a per-pixel
  stencil reduction + segment-mins keyed by region label), all selected
  edges merge simultaneously (hooking + pointer jumping), and region
  statistics (size, color sum -> mean descriptor, constraint id, finalized
  flag) are re-aggregated with segment ops.
- Merge admissibility reproduces the reference semantics
  (segmentation_graph.h:383-439): mean-color descriptor distance
  (pixel_distance.h:469-521) with strict merge threshold 0.05 and the
  force-merge shortcut; regions whose merge test fails are finalized at the
  end of each level; same-constraint regions merge while distance <= split
  threshold 0.15 and are unconstrained (smaller side, or both if within 0.3x
  size) otherwise; different constraints never merge.
- After the schedule: a forced min-region-size phase (small regions merge
  along their minimum incident edge, segmentation_graph.h:407-415) and the
  final constraint association (MergeConstrainedRegions,
  segmentation_graph.h:703-786).

The spatio-temporal graph (N8 spatial + temporal 9-neighborhood,
dense_segmentation_graph.h:956-1142) is never materialized: it is enumerated
as a static stencil.  Merge rounds use the 13 *forward* directions (each
edge proposed by one endpoint's region — sufficient for merging); the
level-end finalization pass enumerates both views so failed tests flag both
regions, as in the reference.  With optical flow, temporal edges anchor at
the flow-displaced, clamped position in the previous frame
(AddTemporalFlowEdgesImpl); reverse views are approximated by the
undisplaced neighborhood (exact when flow is absent).

All per-direction neighbor features come from one roll of a packed
(T,H,W,C) feature tensor, keeping the compiled program small and the
round bandwidth-bound rather than gather-bound.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.ops import cc

NUM_BUCKETS = 2048
_I32MAX = jnp.iinfo(jnp.int32).max

SPATIAL_FWD = ((0, 1), (1, 0), (1, -1), (1, 1))
SPATIAL_ALL = SPATIAL_FWD + ((0, -1), (-1, 0), (-1, 1), (-1, -1))
TEMPORAL_DIRS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# Packed feature channels.
_C_VOL = slice(0, 3)
_C_MEAN = slice(3, 6)
_C_SIZE = 6
_C_CONSTR = 7
_C_FIN = 8
_C_FROZEN = 9
_NUM_F = 10

MODE_MERGE = 0
MODE_MIN_SIZE = 1


class OversegParams(NamedTuple):
    merge_threshold: float = 0.05      # pixel_distance.h:471
    split_threshold: float = 0.15      # pixel_distance.h:472
    force_merge_weight: float = 0.001  # dense_segmentation.cpp:259 (L2)
    min_region_size: int = 100
    metric: str = "l2"
    # Static bound on distinct constraint ids per solve (keeps the compiled
    # program independent of the actual count, avoiding per-chunk recompiles).
    max_constraints: int = 1 << 16
    # Region descriptor trait for the merge gate: "color_mean" (L1/L2 on
    # means, pixel_distance.h:469-521) or "color_mean_variance"
    # (Bhattacharyya z-score on means over pooled variance,
    # pixel_distance.h:566-638; pair with thresholds 0.1/0.75).
    descriptor: str = "color_mean"
    # Gradient second trait (GradientDiff* pixel distance +
    # GradientMeanDescriptorTraits, pixel_distance.h:160-175,523-561):
    # edge weights and the merge gate combine the color and gradient
    # distances via `aggregator` ("linear" with `linear_weight` on color,
    # "independent", or "sqrt" — pixel_distance.h:712-744); merge/split
    # thresholds aggregate the per-trait thresholds the same way
    # (AggregatedDescriptorTraits, pixel_distance.h:755-821).
    # Edge-table solver only.
    gradient_trait: bool = False
    aggregator: str = "independent"
    linear_weight: float = 0.5
    # Ascending bucket thresholds; each runs Boruvka rounds to a fixed
    # point.  Fine-grained by default: table-space rounds are cheap, and
    # finer levels track the reference's strict ascending edge order more
    # closely (round-2 sweep: level-0 boundary F 0.71 -> 0.79).
    schedule: tuple = (4, 16, 48, 128, 256, 512, 896, 1408, 2047)
    max_rounds_per_level: int = 5
    max_final_rounds: int = 12
    min_size_rounds: int = 12
    # After `compact_after_levels` schedule levels, the region space is
    # renumbered into a dense table of n_pix//compact_divisor slots, making
    # per-round statistics updates cost O(regions) instead of O(pixels).
    # Regions beyond the table (pathological inputs only) become inert.
    compact_after_levels: int = 1
    compact_divisor: int = 2
    # Segment spatial edges over the full schedule first, then everything
    # (SegmentGraphSpatially, dense_segmentation_graph.h:406-416).
    two_stage: bool = False
    # Edge-table solver (v2): compact immediately, extract the region
    # adjacency once, and run all schedule levels / min-size / constraint
    # phases on O(regions) tables.  Requires callers to pre-collapse pixels
    # (tile preseg at `preseg_threshold`) so live regions fit the table.
    edge_table: bool = True
    edge_topk: int = 12
    # Region-table size divisor for the edge-table path (every table round
    # costs O(table); overflow falls into the inert sink, so preseg must
    # keep live regions below n_pix/table_divisor).
    table_divisor: int = 8
    # Distance below which tile preseg floods pixels together when feeding
    # the edge-table solver (bucket ~20 of 2048: merges the reference would
    # accept at its earliest levels; region means cannot drift materially).
    preseg_threshold: float = 0.01
    # Static edge-table size for the v2 solver; 0 = derive from
    # n_pix/table_divisor.  Callers (core/dense.py) count the live preseg
    # seeds per chunk and pass a quantized bucket, so the table tracks the
    # actual region count instead of a worst-case pixel fraction — every
    # table-phase round costs O(table), so this is the solve's main
    # throughput lever.  Quantization keeps the program count per
    # resolution small (the compile-cache invariant).
    table_slots: int = 0
    # Spatial row-band decomposition of the pixel phases (init, edge
    # extraction).  bands>1 splits H into equal bands processed one at a
    # time (lax.map), bounding peak pixel-phase memory to one band, so
    # 720p/1080p keep the reference's 20-frame chunks
    # (dense_segmentation.h:64-75 geometry) under the device's memory
    # bound (DenseSegmentationOptions.max_solve_voxels).  Band boundaries
    # must fall on multiples of 8
    # rows (the tile preseg's subtile height) so preseg regions never span
    # bands.  Cross-band adjacency is restored by a boundary-row edge pass
    # (spatial + undisplaced-temporal crossing directions); flow-displaced
    # temporal edges are clamped within their band — a one-row
    # approximation at B-1 seams.  The table phases run globally, so the
    # merge semantics away from extraction are identical to bands=1.
    bands: int = 1
    # Per-band table slots when bands>1 (live preseg seeds are counted per
    # chunk and the max over bands is used, quantized).
    band_table_slots: int = 0
    # Process bands with vmap instead of a sequential lax.map: all bands
    # resident at once, so the band dimension can be sharded over a device
    # mesh "space" axis (parallel/mesh.sharded_oversegment) — the
    # multi-chip spatial decomposition of the solve.  Single chip keeps
    # the sequential map (bounded memory).
    bands_vmap: bool = False
    # Bucket schedule of the tile-local felz pre-solve.  Deliberately
    # SHALLOW: deep local schedules finalize regions on high-bucket
    # in-tile edges before the global phase can merge their low-bucket
    # cross-tile edges (order inversion at the handoff) — the dominant
    # level-0 quality artifact of round 2 (horizontal band boundaries).
    # theta<=96 balances that against live-region count (73k per 480p
    # chunk vs 274k at theta<=32, which overflowed the region table).
    preseg_schedule: tuple = (4, 32, 96)
    # Carry the local pre-solve's failed-merge-test flags into the global
    # phases.  Off = finalization develops only from global level-end
    # tests (coarser, merges further).
    carry_preseg_fin: bool = True
    # Only tile-local failures at >= margin * merge_threshold are carried.
    # Under the old BLANKET-flag fin semantics the margin (1.5) was load-
    # bearing: carried fins blocked even zero-weight cross-tile merges, so
    # borderline failures fragmented the overseg ~40% finer than the
    # reference (round-3 sweep: carry-all F 0.761/0.663/0.337 vs
    # carry-none 0.730/0.620/0.442).  With LEVEL fins (block only at
    # bucket >= the failing bucket) carrying every failure is the
    # reference-faithful setting, so the default is 1.0; the margin knob
    # remains for tuning.
    preseg_fin_margin: float = 1.0
    # Run theta-gated min-size forcing rounds after each schedule level's
    # merge rounds, mirroring the reference's in-traversal small-region
    # absorption (segmentation_graph.h:407-415: a failed merge test whose
    # endpoint is below min_region_size merges immediately at the current
    # bucket) instead of only in the single end-of-schedule pass.  0 = off
    # (end pass only); N>0 = N forcing rounds per schedule level.
    min_size_interleave: int = 0
    # Re-run the failed-merge-test scan BEFORE every merge round instead of
    # only at level end.  The reference tests each edge exactly when its
    # bucket is reached and finalizes both endpoints on the first failure
    # (segmentation_graph.h:383-402) — with level-end-only scans, a region
    # can keep growing through several Boruvka rounds after a failure the
    # reference would already have frozen it on.  Per-round scans cost one
    # extra table pass per round (O(table)) and track the reference's
    # strict ascending-order finalization much more closely.
    fin_every_round: bool = False
    # Eager per-round finalization INSIDE the tile preseg: failed merge
    # tests freeze both endpoints with a one-round lag instead of only at
    # level ends.  The preseg schedule reaches bucket 96 (~distance 0.047,
    # just under the 0.05 merge gate), so most texture-scale merge/freeze
    # decisions happen in-tile — the global fin_every_round knob cannot
    # recover detail the preseg already merged through
    # (segmentation_graph.h:383-402 eager semantics).  Default on since the
    # round-5 sweep: with gated scans it lifted F at every level
    # (0.705/0.627/0.447 -> 0.713/0.713/0.647 at 0/0.4/0.75).
    preseg_fin_eager: bool = True
    # Gate the tile preseg's failure scans like the reference's merge test
    # (segmentation_graph.h:388: "Only test if neither region is
    # finalized"): an edge to an already-finalized neighbor cannot
    # finalize this region.  The global table scan is already gated this
    # way (_table_level_end); ungated tile scans over-fragment smooth
    # areas via spurious finalization.  Default on (round-5 sweep; see
    # preseg_fin_eager).
    preseg_fin_gated: bool = True
    # Boruvka merge rounds per tile-preseg schedule level: an int, or a
    # per-level tuple (len == len(preseg_schedule)) — e.g. many depth-1
    # rounds at the low-theta levels (near-identical colors converge
    # safely in-tile) and few at the texture-forming top level, so the
    # global solver inherits fewer seeds without losing mosaic detail.
    preseg_rounds_per_level: int | tuple = 2
    # Depth-1 hooking in the TILE preseg's merge rounds (the in-tile
    # counterpart of pair_merge below; texture cells mostly form in-tile,
    # so in-tile chain collapse is the larger share of the stale-mean
    # over-merge).  QUALITY KNOB, off by default: the round-5 sweeps
    # measured F at levels 0/0.4/0.75 of 0.812/0.758/0.664 with it on
    # (vs 0.713/0.713/0.647 default) — the largest quality lever found,
    # matching the reference's re-evaluate-after-every-merge order
    # (segmentation_graph.h:339-463) by leaving ~700k tiny fragments
    # per 480p chunk for the global solver's whole-region statistics.
    # That granularity multiplies the global solve's table work (every
    # coarser point lost the F gain in the round-5 sweeps), so it ships as
    # an opt-in (--solver_param preseg_pair_merge=1) until its cost is
    # measured on the GPU (ROADMAP).
    preseg_pair_merge: bool = False
    # Depth-1 hooking in global merge rounds: cancel hooks whose target
    # also hooks, so every merge is tested against current statistics (no
    # chain collapse through stale means — see _apply_merge).  Extra rounds,
    # same per-round cost; min-size forcing rounds stay unrestricted.
    pair_merge: bool = False
    # Depth-1 hooking in min-size FORCING rounds: the reference forces one
    # edge at a time and re-checks size after each (segmentation_graph.h:
    # 407-415 — a fragment reaching min_region_size stops absorbing);
    # chained forcing collapses whole fragment chains into one oversized
    # blob, flattening texture mosaics the golden keeps at ~min-size
    # granularity.  Sweep knob, independent of pair_merge.
    pair_merge_minsize: bool = False
    # Supertile-scoped early schedule levels: during the first `st_levels`
    # schedule levels, merge rounds admit only FREE region pairs whose
    # current roots lie in the same (st_h, st_w) supertile of the chunk
    # volume (constrained pairs wait for level st_levels, like
    # cross-supertile edges).  Level-end failure scans stay GLOBAL
    # (fins from the full edge set — the round-5 sweeps showed local FINS
    # at small scope freeze the wrong boundaries, while merge LOCALITY by
    # itself is benign at supertile scope).  Cross-supertile edges simply
    # wait: they are re-tested at level `st_levels` with the merged
    # statistics, like any edge the schedule has not yet reached.  The
    # point is cost, not semantics: with fine presegs (preseg_pair_merge),
    # the early levels own most of the live-region collapse.
    st_levels: int = 0
    st_h: int = 64
    st_w: int = 256


class SolverState(NamedTuple):
    label: jnp.ndarray   # (N,) int32: root slot per voxel
    csum: jnp.ndarray    # (N,3) f32: color sums at root slots
    size: jnp.ndarray    # (N,)  f32: voxel counts at root slots
    constr: jnp.ndarray  # (N,)  int32: compact constraint id at roots, -1 free
    fin: jnp.ndarray     # (N,)  int32: finalize level — minimum bucket of a
                         # failed merge test; merges admit only at bucket <
                         # fin (NUM_BUCKETS = open, 0 = fully blocked)
    frozen: jnp.ndarray  # (N,)  bool: virtual-node role (emitted geometry;
                         # constraint never reset, merged with group at end)
    sqsum: jnp.ndarray   # (N,3) f32: color square sums (variance trait)
    gsum: jnp.ndarray | None = None  # (N,2) f32: sign-normalized gradient
                                     # sums (gradient trait), else None


class OversegResult(NamedTuple):
    """Solver output.  Region attributes are SLOT-spaced (table slots, a
    few 100k at most) rather than scattered over pixel space, so the host
    fetches O(regions) values, not O(pixels).  `orig` maps live slots to
    the original root voxel ids used in `label`; look attributes up via
    `region_attrs`."""
    label: jnp.ndarray   # (T,H,W) int32 original root voxel id per voxel
    constr: jnp.ndarray  # (S,) int32 constraint id per live slot (-1 free)
    size: jnp.ndarray    # (S,) f32 region size per live slot (0 dead)
    orig: jnp.ndarray    # (S,) int32 original root voxel id (-1 dead)
    # Compressed label transport (edge-table solver only): label ==
    # lut[label16] wherever nsink == 0.  The uint16 volume is half the
    # bytes of `label` to download; hosts fetch it and reconstruct,
    # falling back to `label` when sink pixels exist.
    label16: jnp.ndarray | None = None  # (T,H,W) uint16 final slot per voxel
    lut: jnp.ndarray | None = None      # (cap,) int32 slot -> root voxel id
    nsink: jnp.ndarray | None = None    # () int32 count of sink pixels
    # VST_SOLVE_DIAG=1 only (env-gated at trace time; default programs are
    # unchanged): per schedule level [table cap, merge rounds used, live
    # regions after the level] — the solve's cost structure, since every
    # table round costs O(cap * K).
    diag: jnp.ndarray | None = None     # (n_levels, 3) int32


def region_attrs(res: OversegResult, roots):
    """(constr, size) for original-root ids `roots` (e.g. np.unique of the
    label volume).  Roots with no live slot (sink overflow) come back
    unconstrained with size 0."""
    orig = np.asarray(res.orig)
    order = np.argsort(orig)
    so = orig[order]
    pos = np.minimum(np.searchsorted(so, roots), len(so) - 1)
    ok = so[pos] == roots
    idx = order[pos]
    constr = np.where(ok, np.asarray(res.constr)[idx], -1)
    size = np.where(ok, np.asarray(res.size)[idx], 0.0)
    return constr, size


def _dist(a, b, metric):
    d = a - b
    if metric == "l1":
        return jnp.sum(jnp.abs(d), axis=-1) * (1.0 / 3.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1) * (1.0 / 3.0))


class _Dir(NamedTuple):
    """One stencil direction's neighbor view, all (T,H,W)-shaped."""
    valid: jnp.ndarray
    nb_label: jnp.ndarray
    bucket: jnp.ndarray
    nb_mean: jnp.ndarray
    nb_size: jnp.ndarray
    nb_constr: jnp.ndarray
    nb_fin: jnp.ndarray
    nb_frozen: jnp.ndarray
    temporal: jnp.ndarray = True  # scalar: crosses frames (traced in scans)


def _features(state: SolverState, vol):
    """Pack per-voxel features [color, root mean, size, constr, fin, frozen]
    into one (T,H,W,C) tensor (single fused gather by label)."""
    t, h, w, _ = vol.shape
    mean = state.csum / jnp.maximum(state.size, 1.0)[:, None]
    table = jnp.concatenate(
        [mean, state.size[:, None], state.constr.astype(jnp.float32)[:, None],
         state.fin.astype(jnp.float32)[:, None],
         state.frozen.astype(jnp.float32)[:, None]], axis=1)
    g = table[state.label].reshape(t, h, w, 7)
    feats = jnp.concatenate([vol, g], axis=-1)
    label3 = state.label.reshape(t, h, w)
    return feats, label3


def _unpack(fn, labn):
    return dict(nb_label=labn, nb_mean=fn[..., _C_MEAN],
                nb_size=fn[..., _C_SIZE],
                nb_constr=fn[..., _C_CONSTR].astype(jnp.int32),
                nb_fin=fn[..., _C_FIN], nb_frozen=fn[..., _C_FROZEN] > 0)


def _bucketize(d):
    return jnp.clip((d * NUM_BUCKETS).astype(jnp.int32), 0, NUM_BUCKETS - 1)


def _shift_dir_list(spatial_dirs, flow_absent, include_temporal_fwd):
    """(D,3) [(dt,dy,dx)] array of shift-expressible directions."""
    dirs = [(0, dy, dx) for dy, dx in spatial_dirs]
    if flow_absent:
        dirs += [(-1, dy, dx) for dy, dx in TEMPORAL_DIRS]
    if include_temporal_fwd:
        dirs += [(1, dy, dx) for dy, dx in TEMPORAL_DIRS]
    return dirs


class _RawDir(NamedTuple):
    """One direction's raw neighbor view: validity, color bucket, neighbor
    label, and the full neighbor feature slab (nf channels)."""
    valid: jnp.ndarray
    bucket: jnp.ndarray
    nb_label: jnp.ndarray
    fn: jnp.ndarray
    temporal: jnp.ndarray = True


def _fold_dirs_raw(feats, label3, flow, metric, spatial_dirs,
                   include_temporal_fwd, fold_fn, carry, pair_dist=None):
    """Fold `fold_fn(carry, _RawDir) -> carry` over every incident direction.

    Shift-expressible directions (spatial N8, undisplaced temporal) run in a
    lax.scan over traced (dt,dy,dx) — ONE compiled body regardless of the
    direction count, which keeps the compiled program small at large
    shapes.  Flow-displaced directions share a single
    stacked gather and a second scan.  `feats` may carry any channel count;
    channels [0:3] must be the color volume (bucket source)."""
    t, h, w, nf = feats.shape
    n = h * w
    if pair_dist is None:
        pair_dist = lambda a, b: _dist(a[..., _C_VOL], b[..., _C_VOL],
                                       metric)  # noqa: E731
    ys = jnp.arange(h)[None, :, None]
    xs = jnp.arange(w)[None, None, :]
    ts = jnp.arange(t)[:, None, None]

    # Temporal directions exist only for t>1: at t==1 folding them anyway
    # would advance the caller's fold counter past its sized table (e.g.
    # _extract_edges' d_cols) and clobber valid columns via clamped
    # dynamic_update_slice starts.
    dirs = _shift_dir_list(spatial_dirs, flow is None and t > 1,
                           include_temporal_fwd and t > 1)

    # One-time halo pad; each scanned direction is then a single
    # dynamic_slice (a traced-shift jnp.roll would lower to a doubling
    # concatenate per direction — twice the memory and traffic).
    fpad = jnp.pad(feats, ((1, 1), (1, 1), (1, 1), (0, 0)))
    lpad = jnp.pad(label3, ((1, 1), (1, 1), (1, 1)))

    def shift_body(c, d3):
        dt, dy, dx = d3[0], d3[1], d3[2]
        fn = jax.lax.dynamic_slice(
            fpad, (1 + dt, 1 + dy, 1 + dx, 0), (t, h, w, nf))
        labn = jax.lax.dynamic_slice(lpad, (1 + dt, 1 + dy, 1 + dx),
                                     (t, h, w))
        valid = ((ts + dt >= 0) & (ts + dt < t)
                 & (ys + dy >= 0) & (ys + dy < h)
                 & (xs + dx >= 0) & (xs + dx < w))
        bucket = _bucketize(pair_dist(feats, fn))
        d = _RawDir(valid=valid, bucket=bucket, nb_label=labn, fn=fn,
                    temporal=dt != 0)
        return fold_fn(c, d), None

    carry, _ = jax.lax.scan(shift_body, carry,
                            jnp.asarray(dirs, jnp.int32))

    if flow is None or t == 1:
        return carry

    # Flow-displaced backward edges: voxel (t,y,x), t>=1, anchors at
    # clamp(trunc((y,x)+flow[t-1])) in frame t-1 (C truncation toward zero,
    # validity tested on anchor coords — GetLocalEdges).  All nine offsets
    # share one index array (anchor + constant), so the nine neighborhoods
    # resolve through a single stacked gather.
    px = jnp.clip((xs + flow[..., 0]).astype(jnp.int32), 0, w - 1)
    py = jnp.clip((ys + flow[..., 1]).astype(jnp.int32), 0, h - 1)
    prev_f = feats[:-1].reshape(t - 1, n, nf)
    prev_l = label3[:-1].reshape(t - 1, n)

    anchor = py * w + px                              # (T-1,H,W)
    offs = jnp.asarray([dy * w + dx for dy, dx in TEMPORAL_DIRS],
                       jnp.int32)
    flat_all = jnp.clip(anchor[None] + offs[:, None, None, None],
                        0, n - 1)                     # (9,T-1,H,W)
    idx = jnp.transpose(flat_all.reshape(9, t - 1, n),
                        (1, 0, 2)).reshape(t - 1, 9 * n)
    fn_all = jnp.take_along_axis(prev_f, idx[:, :, None], axis=1)
    fn_all = jnp.transpose(fn_all.reshape(t - 1, 9, n, nf),
                           (1, 0, 2, 3)).reshape(9, t - 1, h, w, nf)
    labn_all = jnp.take_along_axis(prev_l, idx, axis=1)
    labn_all = jnp.transpose(labn_all.reshape(t - 1, 9, n),
                             (1, 0, 2)).reshape(9, t - 1, h, w)
    dyx = jnp.asarray(TEMPORAL_DIRS, jnp.int32)       # (9,2)

    def pad_first(x, fill=0):
        widths = [(1, 0)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    def flow_body(c, xs_scan):
        fn, labn, d2 = xs_scan
        ny = py + d2[0]
        nx = px + d2[1]
        valid2 = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        bucket = _bucketize(pair_dist(feats[1:], fn))
        d = _RawDir(valid=pad_first(valid2, False),
                    bucket=pad_first(bucket),
                    nb_label=pad_first(labn),
                    fn=pad_first(fn), temporal=jnp.bool_(True))
        return fold_fn(c, d), None

    carry, _ = jax.lax.scan(flow_body, carry, (fn_all, labn_all, dyx))
    return carry


def _fold_dirs(feats, label3, flow, metric, spatial_dirs,
               include_temporal_fwd, fold_fn, carry):
    """_fold_dirs_raw with the packed-feature channel map decoded into
    _Dir records (constraint ids re-filled with -1 on flow-pad rows)."""

    def raw_fold(c, rd: _RawDir):
        fields = _unpack(rd.fn, rd.nb_label)
        # Flow-scan first-frame padding zero-fills features; a zero constr
        # channel would read as constraint 0, so force -1 where invalid.
        fields["nb_constr"] = jnp.where(rd.valid, fields["nb_constr"], -1)
        d = _Dir(valid=rd.valid, bucket=rd.bucket, temporal=rd.temporal,
                 **fields)
        return fold_fn(c, d)

    return _fold_dirs_raw(feats, label3, flow, metric, spatial_dirs,
                          include_temporal_fwd, raw_fold, carry)


def _desc_distance(own_mean, nb_mean, bucket, p: OversegParams):
    d = _dist(own_mean, nb_mean, p.metric)
    w_eff = bucket.astype(jnp.float32) * (1.0 / NUM_BUCKETS)
    force = (w_eff < p.force_merge_weight) & (d < 0.2)
    return jnp.where(force, 0.0, d)


def _trait_distance(mean_a, var_a, mean_b, var_b, bucket, p: OversegParams):
    """Descriptor-trait merge distance.

    color_mean: L1/L2 on means with the force-merge shortcut
    (pixel_distance.h:469-521).  color_mean_variance: Bhattacharyya-style
    z-score of the mean difference over the pooled per-channel variance,
    scaled by 0.2 and clamped to 1 (pixel_distance.h:571-587; no force
    shortcut — the reference only instantiates it for the mean traits)."""
    if p.descriptor == "color_mean_variance":
        mv = jnp.maximum(1e-4, 0.5 * (var_a + var_b))
        diff = mean_a - mean_b
        d = jnp.sqrt(jnp.sum(diff * diff / mv, axis=-1)) * 0.2
        return jnp.minimum(d, 1.0)
    return _desc_distance(mean_a, mean_b, bucket, p)


def _thresholds(p: OversegParams):
    """Effective (merge, split) descriptor thresholds: with the gradient
    trait, the per-trait thresholds aggregate like the distances
    (AggregatedDescriptorTraits, pixel_distance.h:762-772)."""
    if not p.gradient_trait:
        return p.merge_threshold, p.split_threshold
    from video_segment_tpu.ops import pixel_distance as pd
    return (pd.aggregate_scalar(p.merge_threshold,
                                pd.GRADIENT_MERGE_THRESHOLD,
                                p.aggregator, p.linear_weight),
            pd.aggregate_scalar(p.split_threshold,
                                pd.GRADIENT_SPLIT_THRESHOLD,
                                p.aggregator, p.linear_weight))


def _pair_dist_fn(p: OversegParams, nf: int):
    """Pixel-edge distance over packed (..., nf) features (color in
    channels 0:3, gradient in 3:5 when present): the bucket source for
    edge extraction, aggregated per AggregatedDistance."""
    if not p.gradient_trait or nf < 5:
        return lambda a, b: _dist(a[..., 0:3], b[..., 0:3], p.metric)
    from video_segment_tpu.ops import pixel_distance as pd

    def fn(a, b):
        dc = _dist(a[..., 0:3], b[..., 0:3], p.metric)
        dg = pd.gradient_distance(a[..., 3:5], b[..., 3:5], p.metric)
        return pd.aggregate(dc, dg, p.aggregator, p.linear_weight)

    return fn


def _pair_gate(p: OversegParams, is_min_size):
    """Traced pair-cancellation gate for _apply_merge (None = off)."""
    if p.pair_merge and p.pair_merge_minsize:
        return jnp.bool_(True)
    if p.pair_merge:
        return jnp.logical_not(is_min_size)
    if p.pair_merge_minsize:
        return jnp.asarray(is_min_size)
    return None


def _select_partners(best_bucket, best_partner, label_flat, n):
    """Region-level Boruvka selection from per-pixel (bucket, partner) bests:
    two int32 segment-mins (min bucket, then min partner at that bucket —
    a globally consistent tie-break)."""
    r_bucket = jax.ops.segment_min(best_bucket, label_flat, num_segments=n)
    at_min = (best_bucket == r_bucket[label_flat]) & (best_bucket < _I32MAX)
    key2 = jnp.where(at_min, best_partner, _I32MAX)
    return jax.ops.segment_min(key2, label_flat, num_segments=n)


def _apply_merge(state: SolverState, partner, n, up=None,
                 pair_gate=None):
    """Hook roots onto partners (_I32MAX = no hook).  When `up` is given,
    only hooks toward larger (True) / smaller (False) slots apply — monotone
    hooking cannot cycle, which matters because flow-displaced edges are
    seen with different weights from their two endpoints.

    With `pair_gate` (a traced bool; None = off), a hook whose target itself
    hooks this round is cancelled (depth-1 trees): every merge this round is
    tested against the target's CURRENT statistics, never through a chain of
    stale means — closer to the reference's re-evaluation after every single
    merge (segmentation_graph.h:339-463 processes edges one at a time).
    Chains a->b->c otherwise collapse in one round with a->b tested against
    b's pre-round mean; in texture that over-merges (the means drift with
    every absorption).  Costs extra rounds, not extra work per round.  The
    chain end's hook always survives, so every gated round still makes
    progress.

    `n` is the segment-domain size: the pixel count before compaction, the
    compact table size after.  Returns (state, moved, candidates):
    candidates counts regions that had an admissible partner regardless of
    parity, so callers can terminate a phase the moment no admissible edges
    remain."""
    slots = jnp.arange(n, dtype=jnp.int32)
    have = partner < _I32MAX
    hook = have
    if up is not None:
        hook = hook & ((partner > slots) == up)
    if pair_gate is not None:
        tgt = jnp.minimum(partner, n - 1)
        hook = hook & jnp.logical_not(hook[tgt] & pair_gate)
    parent = jnp.where(hook, partner, slots)
    root = cc.pointer_jump(parent)
    # One fused segment-sum carries color sums, size, and the sticky OR'd
    # frozen flag (sum > 0 == OR); constraint ids keep max semantics and
    # finalize levels min semantics (most restrictive member wins).
    cols = [state.csum, state.size[:, None],
            state.frozen.astype(jnp.float32)[:, None], state.sqsum]
    if state.gsum is not None:
        cols.append(state.gsum)
    stats = jax.ops.segment_sum(jnp.concatenate(cols, axis=1), root,
                                num_segments=n)
    constr = jax.ops.segment_max(state.constr, root, num_segments=n)
    fin = jax.ops.segment_min(state.fin, root, num_segments=n)
    label = root[state.label]
    moved = jnp.sum(root != slots)
    return SolverState(label, stats[:, 0:3], stats[:, 3], constr,
                       fin, stats[:, 4] > 0, stats[:, 5:8],
                       stats[:, 8:10] if state.gsum is not None else None
                       ), moved, jnp.sum(have)


def _round(state: SolverState, vol, flow, theta, up, mode, n, sink,
           p: OversegParams, use_temporal=True):
    """One Boruvka round.  mode selects regular-merge or min-size-forcing
    admissibility (one compiled body serves both phases).  `n` is the
    segment-domain size; `sink` the inert overflow slot (-1 when absent) —
    sink regions never merge in either direction.  `use_temporal` (traced)
    masks temporal directions for the two-stage spatial-only pre-pass."""
    t, h, w, _ = vol.shape
    feats, label3 = _features(state, vol)
    own_mean = feats[..., _C_MEAN]
    own_size = feats[..., _C_SIZE]
    own_constr = feats[..., _C_CONSTR].astype(jnp.int32)
    own_fin = feats[..., _C_FIN]
    is_min_size = mode == MODE_MIN_SIZE
    own_small = own_size < p.min_region_size
    own_live = label3 != sink

    def fold(carry, d):
        best_bucket, best_partner = carry
        act = (d.valid & (d.nb_label != label3) & own_live
               & (d.nb_label != sink)
               & (jnp.logical_not(d.temporal) | use_temporal))
        dd = _desc_distance(own_mean, d.nb_mean, d.bucket, p)
        either_free = (own_constr < 0) | (d.nb_constr < 0)
        regular = (either_free & (d.bucket < own_fin) & (d.bucket < d.nb_fin)
                   & (dd < p.merge_threshold))
        constr_same = (~either_free & (own_constr == d.nb_constr)
                       & (dd <= p.split_threshold))
        adm_merge = (d.bucket <= theta) & (regular | constr_same)
        both_constr_diff = (~either_free) & (own_constr != d.nb_constr)
        # theta-gated (see the table variant): the final pass passes
        # theta=NUM_BUCKETS, interleaved passes the level's theta.
        adm_small = own_small & ~both_constr_diff & (d.bucket <= theta)
        adm = act & jnp.where(is_min_size, adm_small, adm_merge)
        bkt = jnp.where(adm, d.bucket, _I32MAX)
        take = adm & ((bkt < best_bucket)
                      | ((bkt == best_bucket) & (d.nb_label < best_partner)))
        return (jnp.where(take, bkt, best_bucket),
                jnp.where(take, d.nb_label, best_partner))

    init = (jnp.full((t, h, w), _I32MAX, jnp.int32),
            jnp.full((t, h, w), _I32MAX, jnp.int32))
    best_bucket, best_partner = _fold_dirs(
        feats, label3, flow, p.metric, SPATIAL_FWD, False, fold, init)

    partner = _select_partners(best_bucket.reshape(-1),
                               best_partner.reshape(-1), state.label, n)
    return _apply_merge(state, partner, n, up=up,
                        pair_gate=_pair_gate(p, is_min_size))


def _level_end(state: SolverState, vol, flow, theta, n, p: OversegParams,
               use_temporal=True):
    """Finalize failed merge tests and unconstrain split regions at level end
    (segmentation_graph.h:399-402, 416-435).  Enumerates both edge views so
    both regions get flagged."""
    t, h, w, _ = vol.shape
    feats, label3 = _features(state, vol)
    own_mean = feats[..., _C_MEAN]
    own_size = feats[..., _C_SIZE]
    own_constr = feats[..., _C_CONSTR].astype(jnp.int32)
    own_fin = feats[..., _C_FIN]
    own_frozen = feats[..., _C_FROZEN] > 0

    def fold(carry, d):
        fail_min, uncon_any = carry
        act = (d.valid & (d.nb_label != label3) & (d.bucket <= theta)
               & (jnp.logical_not(d.temporal) | use_temporal))
        dd = _desc_distance(own_mean, d.nb_mean, d.bucket, p)
        either_free = (own_constr < 0) | (d.nb_constr < 0)
        fail = (act & either_free & (d.bucket < own_fin)
                & (d.bucket < d.nb_fin) & (dd >= p.merge_threshold))
        split = (act & ~either_free & (own_constr == d.nb_constr)
                 & (dd > p.split_threshold))
        # Unconstrain own side unless the neighbor is much smaller (the
        # neighbor then unconstrains itself from its own view).  Frozen
        # regions are never unconstrained.
        uncon = split & ~(d.nb_size < 0.3 * own_size) & ~own_frozen
        return (jnp.minimum(fail_min, jnp.where(fail, d.bucket, _I32MAX)),
                uncon_any | uncon)

    init = (jnp.full((t, h, w), _I32MAX, jnp.int32),
            jnp.zeros((t, h, w), bool))
    fail_min, uncon_any = _fold_dirs(
        feats, label3, flow, p.metric, SPATIAL_ALL, True, fold, init)

    fail_r = jax.ops.segment_min(fail_min.reshape(-1), state.label,
                                 num_segments=n)
    uncon_r = jax.ops.segment_max(uncon_any.reshape(-1).astype(jnp.int32),
                                  state.label, num_segments=n) > 0
    return state._replace(
        fin=jnp.minimum(state.fin, fail_r),
        constr=jnp.where(uncon_r, -1, state.constr))


# ---------------------------------------------------------------------------
# Edge-table solver (v2): collapse pixels early with a gated label flood,
# then extract the region adjacency ONCE and run every remaining phase on
# O(regions)-sized tables.  Replaces per-round O(pixels) stencil folds with
# per-round O(regions * K) fused gathers + segment ops.

_PARTNER_BITS = 20
_PARTNER_MASK = (1 << _PARTNER_BITS) - 1
_MAX_TABLE = 1 << 22  # widest packable table (coarse-bucket mode)


def _pack_spec(nseg: int):
    """Packing layout for (bucket, partner) int32 keys, by table size.

    Tables up to 2^20 slots pack the full 11-bit bucket above 20 partner
    bits.  Larger tables (high-resolution banded solves) use 22 partner
    bits with the bucket coarsened by 4 (9 bits) — the lexicographic
    (bucket, partner) tie-break then resolves within 4-bucket groups,
    a <0.2% weight-resolution loss.  Returns (partner_bits, bucket_shift).
    """
    if nseg <= (1 << _PARTNER_BITS):
        return _PARTNER_BITS, 0
    if nseg > _MAX_TABLE:
        raise ValueError(f"edge table {nseg} exceeds packable {_MAX_TABLE}; "
                         "split the solve into more spatial bands")
    return 22, 2


def _extract_edges(memb3, vol, flow, nseg, sink, p, global_base: int = 0,
                   pack_domain: int | None = None):
    """One-time region-adjacency extraction from pixel space.

    For every stencil direction, aggregates the minimum-bucket pixel edge
    per (region, direction) via packed int32 segment-mins (bucket in the
    high bits, partner id in the low partner bits — the same lexicographic
    (bucket, partner) tie-break the per-round selection uses).  Returns
    packed (D, nseg) int32, _I32MAX where absent: rows [0, n_dirs) hold
    the FORWARD view (own region's min per direction), rows
    [n_dirs, 2*n_dirs) the reverse view.

    Only the forward view reduces over pixel space (one O(N) scatter per
    direction).  The reverse view derives in TABLE space by re-scattering each
    forward column onto its partner slot: O(regions) per direction, ~30x
    fewer scatter elements.  The derived view retains an edge only when it
    won some region's forward per-direction min — the table is already a
    per-(region, direction) min-filter, so the loss is confined to
    reverse-side entries of non-minimal edges; any retained edge can be
    proposed by either endpoint (merging unaffected) and flags both sides
    at level end.

    `global_base` offsets packed partner ids (banded solves extract with
    band-local segment keys but globally addressed partners).
    """
    t, h, w, _ = vol.shape
    bits, bshift = _pack_spec(pack_domain if pack_domain is not None
                              else nseg)
    pmask = (1 << bits) - 1
    memb_flat = memb3.reshape(-1)
    n_dirs = len(SPATIAL_FWD) + (len(TEMPORAL_DIRS) if t > 1 else 0)
    d_cols = 2 * n_dirs

    def fold(carry, d: _RawDir):
        tb, k = carry
        ok = (d.valid & (d.nb_label != memb3)
              & (memb3 != sink) & (d.nb_label != sink))
        bkt = jnp.minimum(d.bucket, NUM_BUCKETS - 2) >> bshift
        pk_a = jnp.where(ok, (bkt << bits) | (d.nb_label + global_base),
                         _I32MAX)
        e_a = jax.ops.segment_min(pk_a.reshape(-1), memb_flat,
                                  num_segments=nseg)
        tb = jax.lax.dynamic_update_slice(tb, e_a[None], (k, 0))
        return tb, k + 1

    tab = jnp.full((d_cols, nseg), _I32MAX, jnp.int32)
    tab, _ = _fold_dirs_raw(vol, memb3, flow, p.metric, SPATIAL_FWD,
                            False, fold, (tab, jnp.int32(0)),
                            pair_dist=_pair_dist_fn(p, vol.shape[-1]))

    # Reverse view from the forward table: column k's entry at slot a,
    # packed (bucket, partner b), re-scatters as (bucket, a) onto slot b.
    fwd = tab[:n_dirs]
    valid = fwd < _I32MAX
    ploc = jnp.clip((fwd & pmask) - global_base, 0, nseg - 1)
    own_g = jnp.arange(nseg, dtype=jnp.int32)[None] + global_base
    rev_val = jnp.where(valid, ((fwd >> bits) << bits) | own_g, _I32MAX)
    kidx = jnp.arange(n_dirs, dtype=jnp.int32)[:, None]
    rev = jax.ops.segment_min(
        rev_val.reshape(-1), (kidx * nseg + ploc).reshape(-1),
        num_segments=n_dirs * nseg).reshape(n_dirs, nseg)
    # The sink row never proposes: its forward row is empty by the `ok`
    # mask, and reverse entries cannot target it (partners exclude sink).
    return jax.lax.dynamic_update_slice(tab, rev, (n_dirs, 0))


def _topk_edges(tab, k):
    """(D, nseg) packed table -> per-slot K smallest distinct edges.

    Returns (partner (nseg,K) int32 with _I32MAX absent,
             bucket (nseg,K) int32 with large sentinel absent).
    Duplicate (bucket, partner) entries collapse (same packed value).
    """
    nseg = tab.shape[1]
    bits, bshift = _pack_spec(nseg)
    pmask = (1 << bits) - 1
    cur = tab.T  # (nseg, D)
    d = cur.shape[1]
    k = min(k, d)
    parts = []
    bkts = []
    for _ in range(k):
        m = jnp.min(cur, axis=1)
        cur = jnp.where(cur == m[:, None], _I32MAX, cur)
        valid = m < _I32MAX
        parts.append(jnp.where(valid, m & pmask, _I32MAX))
        bkts.append(jnp.where(valid, (m >> bits) << bshift, NUM_BUCKETS))
    return jnp.stack(parts, axis=1), jnp.stack(bkts, axis=1)


def _table_round(ts: SolverState, ptn, pbk, theta, up, mode, nseg, sink,
                 p: OversegParams, sup=None, st_on=False):
    """One Boruvka round over the region edge table.

    ts.label is the current root per slot (fully path-compressed).  Edges
    stay anchored at their original extraction slot; merged regions see the
    union of member-slot edges through the segment-min by current root.
    Admissibility matches `_round` (segmentation_graph.h:383-439).

    `sup` (per-slot supertile id) with `st_on` (traced bool) restricts
    merges to FREE same-supertile pairs (OversegParams.st_levels):
    constrained pairs wait for level st_levels, like cross-supertile
    edges.
    """
    root = ts.label
    k = ptn.shape[1]
    bits, _ = _pack_spec(nseg)
    use_var = p.descriptor == "color_mean_variance"
    mean = ts.csum / jnp.maximum(ts.size, 1.0)[:, None]

    own = root                                   # (nseg,) current root of slot
    own_mean = mean[own]
    own_size = ts.size[own]
    own_constr = ts.constr[own]
    own_fin = ts.fin[own]

    ptn_c = jnp.minimum(ptn, nseg - 1)
    a2 = root[ptn_c]                             # (nseg,K) partner roots
    nb_mean = mean[a2]
    nb_constr = ts.constr[a2]
    nb_fin = ts.fin[a2]
    if use_var:
        var = ts.sqsum / jnp.maximum(ts.size, 1.0)[:, None] - mean * mean
        own_var = var[own][:, None, :]
        nb_var = var[a2]
    else:
        own_var = nb_var = None

    live = (ptn < _I32MAX) & (a2 != own[:, None]) \
        & (own[:, None] != sink) & (a2 != sink)
    dd = _trait_distance(own_mean[:, None, :], own_var,
                         nb_mean, nb_var, pbk, p)
    if p.gradient_trait:
        from video_segment_tpu.ops import pixel_distance as pd
        gmean = ts.gsum / jnp.maximum(ts.size, 1.0)[:, None]
        dd = pd.aggregate(
            dd, pd.gradient_trait_distance(gmean[own][:, None, :],
                                           gmean[a2]),
            p.aggregator, p.linear_weight)
    mthr, sthr = _thresholds(p)

    either_free = (own_constr[:, None] < 0) | (nb_constr < 0)
    regular = (either_free & (pbk < own_fin[:, None]) & (pbk < nb_fin)
               & (dd < mthr))
    constr_same = (~either_free & (own_constr[:, None] == nb_constr)
                   & (dd <= sthr))
    adm_merge = (pbk <= theta) & (regular | constr_same)
    if sup is not None:
        # Gated levels admit only FREE same-supertile pairs: constrained
        # pairs wait for level st_levels like cross-supertile edges.
        st_ok = ((sup[own][:, None] == sup[a2])
                 & (own_constr[:, None] < 0) & (nb_constr < 0))
        adm_merge = adm_merge & (st_ok | ~st_on)
    both_constr_diff = (~either_free) & (own_constr[:, None] != nb_constr)
    own_small = own_size < p.min_region_size
    # theta-gated like regular merges: interleaved min-size rounds only
    # force-merge along edges the current bucket level has reached
    # (segmentation_graph.h:407-415 runs inside the bucket traversal); the
    # final min-size pass hands theta=NUM_BUCKETS, i.e. ungated.
    adm_small = own_small[:, None] & ~both_constr_diff & (pbk <= theta)
    is_min_size = mode == MODE_MIN_SIZE
    adm = live & jnp.where(is_min_size, adm_small, adm_merge)

    _, bshift = _pack_spec(nseg)
    packed = jnp.where(adm, ((jnp.minimum(pbk, NUM_BUCKETS - 2) >> bshift)
                             << bits) | a2, _I32MAX)
    best_slot = jnp.min(packed, axis=1)          # (nseg,)
    r_best = jax.ops.segment_min(best_slot, own, num_segments=nseg)
    partner = jnp.where(r_best < _I32MAX, r_best & ((1 << bits) - 1),
                        _I32MAX)
    return _apply_merge(ts, partner, nseg, up=up,
                        pair_gate=_pair_gate(p, is_min_size))


def _table_level_end(ts: SolverState, tab, theta, nseg, sink,
                     p: OversegParams):
    """Level-end finalization / unconstraining over the FULL edge table
    (mirrors `_level_end`; both endpoint views are table columns, so each
    side of an edge gets flagged from its own anchor)."""
    root = ts.label
    bits, bshift = _pack_spec(nseg)
    use_var = p.descriptor == "color_mean_variance"
    mean = ts.csum / jnp.maximum(ts.size, 1.0)[:, None]
    own = root
    own_mean = mean[own]
    own_size = ts.size[own]
    own_constr = ts.constr[own]
    own_fin = ts.fin[own]
    own_frozen = ts.frozen[own]

    pk = tab.T                                   # (nseg, D)
    ptn = jnp.where(pk < _I32MAX, pk & ((1 << bits) - 1), 0)
    bkt = jnp.where(pk < _I32MAX, (pk >> bits) << bshift, NUM_BUCKETS)
    a2 = root[ptn]
    nb_mean = mean[a2]
    nb_constr = ts.constr[a2]
    nb_fin = ts.fin[a2]
    nb_size = ts.size[a2]
    if use_var:
        var = ts.sqsum / jnp.maximum(ts.size, 1.0)[:, None] - mean * mean
        own_var = var[own][:, None, :]
        nb_var = var[a2]
    else:
        own_var = nb_var = None

    live = (pk < _I32MAX) & (a2 != own[:, None]) \
        & (own[:, None] != sink) & (a2 != sink)
    act = live & (bkt <= theta)
    dd = _trait_distance(own_mean[:, None, :], own_var,
                         nb_mean, nb_var, bkt, p)
    if p.gradient_trait:
        from video_segment_tpu.ops import pixel_distance as pd
        gmean = ts.gsum / jnp.maximum(ts.size, 1.0)[:, None]
        dd = pd.aggregate(
            dd, pd.gradient_trait_distance(gmean[own][:, None, :],
                                           gmean[a2]),
            p.aggregator, p.linear_weight)
    mthr, sthr = _thresholds(p)

    either_free = (own_constr[:, None] < 0) | (nb_constr < 0)
    fail = (act & either_free & (bkt < own_fin[:, None]) & (bkt < nb_fin)
            & (dd >= mthr))
    split = (act & ~either_free & (own_constr[:, None] == nb_constr)
             & (dd > sthr))
    uncon = split & ~(nb_size < 0.3 * own_size[:, None]) \
        & ~own_frozen[:, None]

    fail_slot = jnp.min(jnp.where(fail, bkt, _I32MAX), axis=1)
    uncon_slot = jnp.any(uncon, axis=1)
    fail_r = jax.ops.segment_min(fail_slot, own, num_segments=nseg)
    uncon_r = jax.ops.segment_max(uncon_slot.astype(jnp.int32), own,
                                  num_segments=nseg) > 0
    return ts._replace(fin=jnp.minimum(ts.fin, fail_r),
                       constr=jnp.where(uncon_r, -1, ts.constr))


def _merge_constrained(state: SolverState, num_constraints: int, n: int,
                       p: OversegParams):
    """Final constraint association (MergeConstrainedRegions,
    segmentation_graph.h:703-786): frozen (virtual-role) regions always merge
    into their group's representative; real regions merge when descriptor
    distance <= split threshold and are unconstrained otherwise.  Hooks form
    a star onto the representative — no cycles possible.

    Runs in compact space, where live roots are exactly the slots with
    positive size (dead slots re-aggregate to zero)."""
    slots = jnp.arange(n, dtype=jnp.int32)
    is_root = state.size > 0
    cid = jnp.where(is_root & (state.constr >= 0), state.constr,
                    num_constraints)
    frozen_slot = jnp.where(state.frozen, slots, _I32MAX)
    rep_frozen = jax.ops.segment_min(frozen_slot, cid,
                                     num_segments=num_constraints + 1)
    rep_any = jax.ops.segment_min(slots, cid,
                                  num_segments=num_constraints + 1)
    rep = jnp.where(rep_frozen < _I32MAX, rep_frozen, rep_any)

    target = rep[jnp.clip(state.constr, 0, num_constraints - 1)]
    active = (cid < num_constraints) & (target != slots)
    mean = state.csum / jnp.maximum(state.size, 1.0)[:, None]
    if p.descriptor == "color_mean_variance":
        var = (state.sqsum / jnp.maximum(state.size, 1.0)[:, None]
               - mean * mean)
        d = _trait_distance(mean, var, mean[target], var[target],
                            jnp.zeros(n, jnp.int32) + NUM_BUCKETS, p)
    else:
        d = _dist(mean, mean[target], p.metric)
    if p.gradient_trait and state.gsum is not None:
        from video_segment_tpu.ops import pixel_distance as pd
        gmean = state.gsum / jnp.maximum(state.size, 1.0)[:, None]
        d = pd.aggregate(d, pd.gradient_trait_distance(gmean,
                                                       gmean[target]),
                         p.aggregator, p.linear_weight)
    _, sthr = _thresholds(p)
    merge = active & (state.frozen | (d <= sthr))
    uncon = active & ~merge & ~state.frozen

    state = state._replace(constr=jnp.where(uncon, -1, state.constr))
    partner = jnp.where(merge, target, _I32MAX)
    state, _, _ = _apply_merge(state, partner, n)
    return state


def _compact(state: SolverState, n_pix: int, r_cap: int):
    """Renumber live roots into a dense table of r_cap slots (+1 sink).

    Pixels keep compact memberships from here on; roots beyond the table
    (pathological inputs only) map to the inert sink slot r_cap.  Returns
    the compacted state plus the original root id per pixel (for final
    label reconstruction)."""
    slots = jnp.arange(n_pix, dtype=jnp.int32)
    is_root = state.label[slots] == slots
    cidx_all = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    ok = is_root & (cidx_all < r_cap)
    cidx = jnp.where(ok, cidx_all, r_cap)      # per-slot compact id / sink
    clabel = cidx[state.label]                 # per-pixel membership

    nseg = r_cap + 1
    csum = jax.ops.segment_sum(state.csum, cidx, num_segments=nseg)
    sqsum = jax.ops.segment_sum(state.sqsum, cidx, num_segments=nseg)
    size = jax.ops.segment_sum(jnp.where(is_root, state.size, 0.0), cidx,
                               num_segments=nseg)
    constr = jax.ops.segment_max(
        jnp.where(is_root, state.constr, -1), cidx, num_segments=nseg)
    fin = jax.ops.segment_min(
        jnp.where(is_root, state.fin, _I32MAX), cidx, num_segments=nseg)
    frozen = jax.ops.segment_max(
        (is_root & state.frozen).astype(jnp.int32), cidx,
        num_segments=nseg) > 0
    # Sink must never merge: finalize level 0, no constraint.
    fin = fin.at[r_cap].set(0)
    constr = constr.at[r_cap].set(-1)
    cstate = SolverState(clabel, csum, size, constr, fin, frozen, sqsum)
    return cstate, state.label


@functools.partial(
    jax.jit,
    static_argnames=("params", "has_flow", "has_constraints",
                     "head_planes"))
def _solve(vol, flow, init_label, constr_init, frozen_init, fin_init,
           params: OversegParams, has_flow: bool, has_constraints: bool,
           cell_stats=None, head_planes: int = 0):
    t, h, w, _ = vol.shape
    n_pix = t * h * w
    fl = flow if has_flow else None

    if params.edge_table:
        thetas_ = jnp.asarray(params.schedule, jnp.int32)
        lr_ = jnp.asarray(
            [params.max_rounds_per_level] * (len(params.schedule) - 1)
            + [params.max_final_rounds], jnp.int32)
        return _solve_edge_table(vol, fl, init_label, constr_init,
                                 frozen_init, fin_init, params, n_pix,
                                 thetas_, lr_, has_constraints,
                                 cell_stats, head_planes)

    ones = jnp.ones(n_pix, jnp.float32)
    csum = jax.ops.segment_sum(vol.reshape(n_pix, 3), init_label,
                               num_segments=n_pix)
    size = jax.ops.segment_sum(ones, init_label, num_segments=n_pix)
    constr = jax.ops.segment_max(constr_init, init_label,
                                 num_segments=n_pix)
    frozen = jax.ops.segment_max(frozen_init.astype(jnp.int32), init_label,
                                 num_segments=n_pix) > 0
    fin0 = jax.ops.segment_min(fin_init, init_label, num_segments=n_pix)
    volf = vol.reshape(n_pix, 3)
    sqsum = jax.ops.segment_sum(volf * volf, init_label,
                                num_segments=n_pix)
    state = SolverState(init_label, csum, size, constr, fin0, frozen,
                        sqsum)

    def run_rounds(state, theta, max_rounds, mode, n, sink,
                   use_temporal=True, fin_each=False):
        # Hook parity alternates per round.  Terminate immediately once no
        # admissible edges remain, or after two merge-free rounds (both
        # parities blocked).
        scan_each = fin_each and params.fin_every_round

        def cond(carry):
            st, i, idle = carry
            return (idle < 2) & (i < max_rounds)

        def body(carry):
            st, i, idle = carry
            if scan_each:
                st = _level_end(st, vol, fl, theta, n, params,
                                use_temporal)
            st, moved, cands = _round(st, vol, fl, theta, (i % 2) == 0,
                                      mode, n, sink, params, use_temporal)
            idle = jnp.where(cands == 0, 2,
                             jnp.where(moved > 0, 0, idle + 1))
            return st, i + 1, idle

        state, _, _ = jax.lax.while_loop(
            cond, body, (state, jnp.int32(0), jnp.int32(0)))
        return state

    # Levels run inside fori_loops with theta as a traced lookup so each
    # phase's (large) stencil bodies compile exactly once.
    n_levels = len(params.schedule)
    thetas = jnp.asarray(params.schedule, jnp.int32)
    level_rounds = jnp.asarray(
        [params.max_rounds_per_level] * (n_levels - 1)
        + [params.max_final_rounds], jnp.int32)

    def make_level_body(n, sink, use_temporal=True):
        def level_body(l, state):
            state = run_rounds(state, thetas[l], level_rounds[l],
                               jnp.int32(MODE_MERGE), n, sink, use_temporal,
                               fin_each=True)
            state = _level_end(state, vol, fl, thetas[l], n, params,
                               use_temporal)
            if params.min_size_interleave and params.min_region_size > 1:
                state = run_rounds(state, thetas[l],
                                   jnp.int32(params.min_size_interleave),
                                   jnp.int32(MODE_MIN_SIZE), n, sink,
                                   use_temporal)
            return state
        return level_body

    if params.two_stage:
        # Spatial-only pre-pass over the whole schedule
        # (SegmentGraphSpatially, dense_segmentation_graph.h:406-416).
        state = jax.lax.fori_loop(
            0, n_levels,
            make_level_body(n_pix, -1, use_temporal=jnp.bool_(False)), state)

    # Phase A: pixel-space region slots for the first (cheap-theta) levels.
    n_a = min(max(params.compact_after_levels, 0), n_levels)
    state = jax.lax.fori_loop(0, n_a, make_level_body(n_pix, -1), state)

    # Compact, then phase B in the dense region table.
    r_cap = min(max(n_pix // params.compact_divisor, 1 << 14), n_pix)
    nseg = r_cap + 1
    state, orig_label = _compact(state, n_pix, r_cap)

    state = jax.lax.fori_loop(n_a, n_levels, make_level_body(nseg, r_cap),
                              state)

    if params.min_region_size > 1:
        state = run_rounds(state, jnp.int32(NUM_BUCKETS),
                           jnp.int32(params.min_size_rounds),
                           jnp.int32(MODE_MIN_SIZE), nseg, r_cap)

    if has_constraints:
        state = _merge_constrained(state, params.max_constraints, nseg,
                                   params)

    # Reconstruct labels in original root-voxel space: each compact region
    # takes its minimum original root; sink pixels keep their phase-A root.
    sink = r_cap
    orig_min = jax.ops.segment_min(orig_label, state.label,
                                   num_segments=nseg)
    final = jnp.where(state.label == sink, orig_label,
                      orig_min[state.label])
    # Scatter compact-space attributes back to original root slots (the
    # sink pools unrelated overflow regions, so it is excluded — its
    # regions come out unconstrained with sizes recomputed by the caller).
    live = (state.size > 0) & (jnp.arange(nseg) != sink)
    return OversegResult(label=final.reshape(t, h, w),
                         constr=jnp.where(live, state.constr, -1),
                         size=jnp.where(live, state.size, 0.0),
                         orig=jnp.where(live, orig_min, -1))


def _table_cap(params: OversegParams, n_pix: int, h: int, w: int,
               has_constraints: bool) -> int:
    """Static table size: caller-provided live-count bucket, or the
    worst-case pixel-fraction fallback."""
    if params.table_slots:
        return min(params.table_slots, n_pix, _MAX_TABLE - 2)
    extra = ((h * w) // 4 + params.max_constraints) if has_constraints \
        else 0
    return min(max(n_pix // params.table_divisor, 1 << 14) + extra, n_pix,
               _MAX_TABLE - 2)


def _init_table(vol, init_label, constr_init, frozen_init, fin_init,
                r_cap: int, has_constraints: bool, params: OversegParams,
                cell_stats=None, head_planes: int = 0):
    """Fused seed-compaction: renumber self-rooted init labels into table
    slots and aggregate region statistics directly there (one O(N) pass —
    the former pixel-space init + `_compact` did it twice).

    With `cell_stats` (size, c0, c1, c2 — per-region sums CELL-POSITIONED
    at root voxels, as the felz pre-solve exports), per-slot stats GATHER
    from root cells instead of segment-summing all pixels (an O(regions)
    gather in place of a 7-column O(pixels) scatter).  The first
    `head_planes` planes (host-built constraint groups whose cells carry
    no stats) still reduce from their pixels — a nc/t fraction of the
    volume.

    Returns (table SolverState with identity labels, per-pixel membership,
    per-slot original root voxel id)."""
    n_pix = init_label.shape[0]
    t_, h_, w_ = vol.shape[0], vol.shape[1], vol.shape[2]
    nseg = r_cap + 1
    slots = jnp.arange(n_pix, dtype=jnp.int32)
    is_root = init_label == slots
    cidx_all = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    ok = is_root & (cidx_all < r_cap)
    cidx = jnp.where(ok, cidx_all, r_cap)
    memb = cidx[init_label]                    # (N,) pixel -> slot (or sink)
    # Original root voxel per slot (label reconstruction; doubles as the
    # slot -> root-cell index for the stats gathers below).
    orig_slot = jnp.zeros(nseg, jnp.int32).at[cidx].max(
        jnp.where(ok, slots, 0))

    volf = vol.reshape(n_pix, -1)
    color = volf[:, 0:3]
    ones = jnp.ones((n_pix, 1), jnp.float32)
    use_var = params.descriptor == "color_mean_variance"
    use_grad = params.gradient_trait and volf.shape[1] >= 5
    fast = cell_stats is not None and not use_var and not use_grad

    if fast:
        head_n = head_planes * h_ * w_
        size_c, c0, c1, c2 = (x.reshape(n_pix) for x in cell_stats)
        n_active = jnp.sum(ok.astype(jnp.int32))
        valid = jnp.arange(nseg, dtype=jnp.int32) < n_active
        zero_head = (lambda x: jnp.concatenate(
            [jnp.zeros(head_n, x.dtype), x[head_n:]]) if head_n else x)
        size = jnp.where(valid, zero_head(size_c)[orig_slot], 0.0)
        csum = jnp.stack([zero_head(c0)[orig_slot],
                          zero_head(c1)[orig_slot],
                          zero_head(c2)[orig_slot]], axis=1) \
            * valid[:, None].astype(jnp.float32)
        fin = jnp.where(valid, fin_init[orig_slot], _I32MAX)
        if head_n:
            hstats = jax.ops.segment_sum(
                jnp.concatenate([color[:head_n], ones[:head_n]], axis=1),
                memb[:head_n], num_segments=nseg)
            csum = csum + hstats[:, 0:3]
            size = size + hstats[:, 3]
        sqsum = jnp.zeros((nseg, 3), jnp.float32)
        gsum = None
        if has_constraints:
            hm = memb[:head_n] if head_n else memb[:0]
            constr = jnp.maximum(jax.ops.segment_max(
                constr_init[:head_n], hm, num_segments=nseg), -1)
            frozen = jax.ops.segment_max(
                frozen_init[:head_n].astype(jnp.int32), hm,
                num_segments=nseg) > 0
        else:
            constr = jnp.full(nseg, -1, jnp.int32)
            frozen = jnp.zeros(nseg, bool)
    else:
        cols = [color, ones]
        if use_var:
            cols.append(color * color)
        if use_grad:
            from video_segment_tpu.ops import pixel_distance as pd
            cols.append(pd.sign_normalize(volf[:, 3:5]))
        stats = jax.ops.segment_sum(jnp.concatenate(cols, axis=1), memb,
                                    num_segments=nseg)
        csum = stats[:, 0:3]
        size = stats[:, 3]
        off = 4
        if use_var:
            sqsum = stats[:, off:off + 3]
            off += 3
        else:
            sqsum = jnp.zeros((nseg, 3), jnp.float32)
        gsum = stats[:, off:off + 2] if use_grad else None
        if has_constraints:
            constr = jax.ops.segment_max(constr_init, memb,
                                         num_segments=nseg)
            frozen = jax.ops.segment_max(frozen_init.astype(jnp.int32),
                                         memb, num_segments=nseg) > 0
        else:
            constr = jnp.full(nseg, -1, jnp.int32)
            frozen = jnp.zeros(nseg, bool)
        fin = jax.ops.segment_min(fin_init, memb, num_segments=nseg)
    # Sink must never merge: finalize level 0, unconstrained.
    fin = fin.at[r_cap].set(0)
    constr = constr.at[r_cap].set(-1)
    ts = SolverState(jnp.arange(nseg, dtype=jnp.int32), csum, size, constr,
                     fin, frozen, sqsum, gsum)
    return ts, memb, orig_slot


def _solve_edge_table(vol, fl, init_label, constr_init, frozen_init,
                      fin_init, params, n_pix, thetas, level_rounds,
                      has_constraints, cell_stats=None,
                      head_planes: int = 0):
    """Edge-table phases of the v2 solver (see module docstring and the
    OversegParams.edge_table comment).  `fl` is the flow or None."""
    t, h, w, _ = vol.shape
    if params.gradient_trait:
        from video_segment_tpu.ops import pixel_distance as pd
        vol = jnp.concatenate([vol, pd.gradient_features(vol)], axis=-1)
    if params.bands > 1:
        return _solve_banded(vol, fl, init_label, constr_init, frozen_init,
                             fin_init, params, thetas, level_rounds,
                             has_constraints, cell_stats, head_planes)
    r_cap = _table_cap(params, n_pix, h, w, has_constraints)
    nseg = r_cap + 1
    sink = r_cap
    with jax.named_scope("overseg_init_table"):
        ts, memb, orig_slot = _init_table(vol, init_label, constr_init,
                                          frozen_init, fin_init, r_cap,
                                          has_constraints, params,
                                          cell_stats, head_planes)
    with jax.named_scope("overseg_extract_edges"):
        tab = _extract_edges(memb.reshape(t, h, w), vol, fl, nseg, sink,
                             params)
    return _finish_table_solve(ts, tab, memb, orig_slot, init_label,
                               (t, h, w), params, thetas, level_rounds,
                               has_constraints)


_PHASE_Q = 1 << 14      # phase-cap quantization (compile-cache invariant)
_PHASE_FLOOR = 1 << 15  # smallest recompacted table


def _table_phase_caps(nseg0: int) -> tuple:
    """Static shrinking table caps for the schedule phases.

    Every schedule round costs O(cap * K) gathers, but the live region
    count collapses within the first levels; recompacting the table
    mid-schedule (see _recompact_table) cuts the dominant solve cost.
    Caps halve down to a floor, quantized so the compiled-program count
    per resolution stays small.  Halving (not quartering) matters for
    fine presegs: with ~700k seeds the live count after L0 lands just
    above a quarter-step boundary and a second level runs in the full
    seed-sized table (solve-diag, round 5); a denser ladder recompacts
    instead, and phases whose cap the live count already undershoots
    pass through with zero levels (one O(cap) recompact each).  A
    (pathological) solve still carrying more live regions than a cap
    when the schedule ends degrades the overflow regions to their
    merged-so-far labels via the sink — the same overflow contract the
    initial table already has."""
    caps = [nseg0]
    while True:
        tgt = max(caps[-1] // 2, _PHASE_FLOOR)
        nxt = -(-tgt // _PHASE_Q) * _PHASE_Q + 1
        if nxt >= caps[-1]:
            return tuple(caps)
        caps.append(nxt)


def _recompact_table(ts, tab, o2n, fb_slot, orig_slot, new_cap: int):
    """Mid-schedule table shrink (the solver analogue of
    core/agglomeration.py's shrinking phases).

    Renumbers live roots of the current table into a fresh `new_cap`-slot
    table (last slot = sink): region rows gather into the new table, the
    packed edge table remaps endpoints through current roots and re-mins
    per (new slot, direction), the original-slot chain `o2n` composes the
    renumbering, and dying (overflow) regions record their merged-so-far
    label in the per-original-slot fallback `fb_slot`."""
    old_cap = ts.label.shape[0]
    old_sink = old_cap - 1
    new_sink = new_cap - 1
    root = ts.label
    slots = jnp.arange(old_cap, dtype=jnp.int32)
    is_root = (root == slots) & (ts.size > 0) & (slots != old_sink)
    cidx_all = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    ok = is_root & (cidx_all < new_sink)
    cidx = jnp.where(ok, cidx_all, new_sink)     # old root slot -> new slot
    new_of = cidx[root]                          # any old slot -> new slot
    n_active = jnp.sum(ok.astype(jnp.int32))

    # Original-voxel id per old root (min over members): the new rows'
    # orig ids, and dying regions' fallback labels.
    orig_min = jax.ops.segment_min(orig_slot, root, num_segments=old_cap)

    new_slots = jnp.arange(new_cap, dtype=jnp.int32)
    inv = jnp.zeros(new_cap, jnp.int32).at[cidx].max(
        jnp.where(ok, slots, 0))                 # new slot -> old root slot
    valid_new = new_slots < n_active
    vf = valid_new.astype(jnp.float32)[:, None]
    ts2 = SolverState(
        label=new_slots,
        csum=ts.csum[inv] * vf,
        size=ts.size[inv] * vf[:, 0],
        constr=jnp.where(valid_new, ts.constr[inv], -1),
        fin=jnp.where(valid_new, ts.fin[inv], 0),
        frozen=jnp.where(valid_new, ts.frozen[inv], False),
        sqsum=ts.sqsum[inv] * vf,
        gsum=ts.gsum[inv] * vf if ts.gsum is not None else None)

    # Edge table: endpoints through current roots into new slots, repack
    # with the new bit split, per-(new slot, direction) min over old rows.
    bits_o, bshift_o = _pack_spec(old_cap)
    bits_n, bshift_n = _pack_spec(new_cap)
    valid_e = tab < _I32MAX
    ptn_o = jnp.minimum(tab & ((1 << bits_o) - 1), old_cap - 1)
    bkt = (tab >> bits_o) << bshift_o
    p_new = new_of[ptn_o]                        # (D, old_cap)
    ok_e = (valid_e & (p_new != new_sink) & (new_of[None, :] != new_sink)
            & (p_new != new_of[None, :]))
    pk_new = jnp.where(
        ok_e,
        ((jnp.minimum(bkt, NUM_BUCKETS - 2) >> bshift_n) << bits_n) | p_new,
        _I32MAX)
    d_cols = tab.shape[0]
    seg2 = (new_of[None, :]
            + (jnp.arange(d_cols, dtype=jnp.int32) * new_cap)[:, None])
    tab2 = jax.ops.segment_min(pk_new.reshape(-1), seg2.reshape(-1),
                               num_segments=d_cols * new_cap) \
        .reshape(d_cols, new_cap)

    # Original-slot chain + fallback labels for dying regions.
    r_o = root[o2n]                              # original slot -> old root
    died = (r_o != old_sink) & jnp.logical_not(ok[r_o])
    fb_slot2 = jnp.where(died, orig_min[r_o], fb_slot)
    o2n2 = new_of[o2n]
    orig2 = jnp.where(valid_new, orig_min[inv], 0)
    return ts2, tab2, o2n2, fb_slot2, orig2


def _sup_ids_hw(orig, h, w, params):
    """Per-slot supertile id from the slot's original root voxel."""
    n_sx = -(-w // params.st_w)
    tt = orig // (h * w)
    rem = orig % (h * w)
    sid = ((tt * ((h + params.st_h - 1) // params.st_h)
            + (rem // w) // params.st_h) * n_sx
           + (rem % w) // params.st_w)
    return jnp.minimum(sid, jnp.int32(_I32MAX - 1))


def _finish_table_solve(ts, tab, memb, orig_slot, init_label, shape3,
                        params, thetas, level_rounds, has_constraints):
    """Shared tail of the edge-table solver: top-K edges, schedule levels
    over shrinking table phases, min-size forcing, constraint association,
    label reconstruction."""
    t, h, w = shape3
    n_pix = t * h * w
    nseg0 = ts.label.shape[0]
    n_levels = thetas.shape[0]

    def run_rounds(ts, theta, max_rounds, mode, p_tab, b_tab,
                   end_tab=None, sup=None, st_on=False):
        cap = p_tab.shape[0]
        sink = cap - 1
        # `end_tab` is only passed at MERGE call sites; with
        # params.fin_every_round the failure scan runs before every round
        # so a failed test blocks further growth immediately (the
        # reference's per-edge finalization, segmentation_graph.h:383-402)
        # instead of only at the next level boundary.
        scan_each = end_tab is not None and params.fin_every_round

        def cond(carry):
            st, i, idle = carry
            return (idle < 2) & (i < max_rounds)

        def body(carry):
            st, i, idle = carry
            if scan_each:
                st = _table_level_end(st, end_tab, theta, cap, sink,
                                      params)
            st, moved, cands = _table_round(st, p_tab, b_tab, theta,
                                            (i % 2) == 0, mode, cap, sink,
                                            params, sup=sup, st_on=st_on)
            idle = jnp.where(cands == 0, 2,
                             jnp.where(moved > 0, 0, idle + 1))
            return st, i + 1, idle

        ts, n_used, _ = jax.lax.while_loop(cond, body,
                                           (ts, jnp.int32(0), jnp.int32(0)))
        return ts, n_used

    def _sup_ids(orig, cap):
        return _sup_ids_hw(orig, h, w, params)

    if params.two_stage:
        # Spatial-only pre-pass over the whole schedule
        # (SegmentGraphSpatially, dense_segmentation_graph.h:406-416):
        # spatial directions occupy extraction rows [0:4] (forward view)
        # and [n_dirs:n_dirs+4] (reverse view).
        nd = len(SPATIAL_FWD) + (len(TEMPORAL_DIRS) if t > 1 else 0)
        sp = len(SPATIAL_FWD)
        tab_sp = jnp.concatenate([tab[:sp], tab[nd:nd + sp]], axis=0)
        ptn_s, pbk_s = _topk_edges(tab_sp, params.edge_topk)

        def level_body_s(l, ts):
            ts, _ = run_rounds(ts, thetas[l], level_rounds[l],
                               jnp.int32(MODE_MERGE), ptn_s, pbk_s,
                               end_tab=tab_sp)
            return _table_level_end(ts, tab_sp,
                                    thetas[l], nseg0, nseg0 - 1, params)

        ts = jax.lax.fori_loop(0, thetas.shape[0], level_body_s, ts)
        # The spatial pass's finalizations do not carry into the full pass
        # (the reference rebuilds the graph state for the full run); the
        # sink stays blocked.
        ts = ts._replace(fin=jnp.full_like(ts.fin, NUM_BUCKETS)
                         .at[nseg0 - 1].set(0))

    # Schedule levels over shrinking table phases: each phase runs levels
    # while the live count does not yet fit the next phase's table, then
    # recompacts.  Levels advance globally (`l`), so every level runs
    # exactly once regardless of which phase hosts it.
    caps = _table_phase_caps(nseg0)
    o2n = jnp.arange(nseg0, dtype=jnp.int32)
    fb_slot = jnp.zeros(nseg0, jnp.int32)
    l = jnp.int32(0)
    ptn = pbk = None
    import os
    diag = (jnp.zeros((int(thetas.shape[0]), 3), jnp.int32)
            if os.environ.get("VST_SOLVE_DIAG") else None)
    for pi, cap in enumerate(caps):
        sink = cap - 1
        if pi > 0:
            with jax.named_scope(f"overseg_recompact_{cap}"):
                ts, tab, o2n, fb_slot, orig_slot = _recompact_table(
                    ts, tab, o2n, fb_slot, orig_slot, cap)
        with jax.named_scope("overseg_topk_edges"):
            ptn, pbk = _topk_edges(tab, params.edge_topk)
        # Level-end failure tests sweep the full extraction table when it
        # is affordable; very large (banded) tables fall back to the
        # per-slot top-K edges (higher-bucket incident edges then miss
        # failure flags, an approximation accepted at that scale).
        if cap <= (1 << _PARTNER_BITS):
            end_tab = tab
        else:
            bits, bshift = _pack_spec(cap)
            end_tab = jnp.where(ptn < _I32MAX,
                                ((jnp.minimum(pbk, NUM_BUCKETS - 2)
                                  >> bshift) << bits) | ptn, _I32MAX).T
        next_cap = caps[pi + 1] if pi + 1 < len(caps) else 0
        slots_c = jnp.arange(cap, dtype=jnp.int32)

        def cond(carry, next_cap=next_cap):
            ts_, l_, act_, _dg = carry
            go = l_ < n_levels
            if next_cap:
                go = go & (act_ > next_cap - 2)
            return go

        sup = _sup_ids(orig_slot, cap) if params.st_levels > 0 else None

        def body(carry, ptn=ptn, pbk=pbk, end_tab=end_tab, cap=cap,
                 sink=sink, slots_c=slots_c, sup=sup):
            ts_, l_, act_, dg = carry
            ts_, n_used = run_rounds(ts_, thetas[l_], level_rounds[l_],
                                     jnp.int32(MODE_MERGE), ptn, pbk,
                                     end_tab=end_tab, sup=sup,
                                     st_on=l_ < params.st_levels)
            ts_ = _table_level_end(ts_, end_tab, thetas[l_], cap, sink,
                                   params)
            if params.min_size_interleave and params.min_region_size > 1:
                ts_, _ = run_rounds(ts_, thetas[l_],
                                    jnp.int32(params.min_size_interleave),
                                    jnp.int32(MODE_MIN_SIZE), ptn, pbk)
            act_ = jnp.sum(((ts_.label == slots_c)
                            & (ts_.size > 0)).astype(jnp.int32))
            if dg is not None:
                dg = dg.at[l_].set(
                    jnp.stack([jnp.int32(cap), n_used, act_]))
            return ts_, l_ + 1, act_, dg

        active0 = jnp.sum(((ts.label == slots_c)
                           & (ts.size > 0)).astype(jnp.int32))
        with jax.named_scope(f"overseg_schedule_phase_{cap}"):
            ts, l, _, diag = jax.lax.while_loop(
                cond, body, (ts, l, active0, diag))

    cap_f = caps[-1]
    sink_f = cap_f - 1
    if params.min_region_size > 1:
        ts, _ = run_rounds(ts, jnp.int32(NUM_BUCKETS),
                           jnp.int32(params.min_size_rounds),
                           jnp.int32(MODE_MIN_SIZE), ptn, pbk)

    if has_constraints:
        ts = _merge_constrained(ts, params.max_constraints, cap_f, params)

    # Reconstruct labels in original root-voxel space (same scheme as the
    # v1 tail): each live region takes its minimum original root; sink
    # pixels keep their merged-so-far label (fallback), or their pre-table
    # root if they overflowed at seed time.
    orig_min = jax.ops.segment_min(orig_slot, ts.label, num_segments=cap_f)
    root_px = ts.label[o2n[memb]]
    fb_px = jnp.where(memb == nseg0 - 1, init_label, fb_slot[memb])
    final = jnp.where(root_px == sink_f, fb_px, orig_min[root_px])
    live = (ts.size > 0) & (jnp.arange(cap_f) != sink_f)
    can16 = cap_f <= (1 << 16)   # static: final slots fit uint16
    return OversegResult(label=final.reshape(t, h, w),
                         constr=jnp.where(live, ts.constr, -1),
                         size=jnp.where(live, ts.size, 0.0),
                         orig=jnp.where(live, orig_min, -1),
                         label16=(root_px.reshape(t, h, w)
                                  .astype(jnp.uint16) if can16 else None),
                         lut=orig_min if can16 else None,
                         nsink=(jnp.sum((root_px == sink_f)
                                        .astype(jnp.int32))
                                if can16 else None),
                         diag=diag)


def _boundary_edges(vol, memb_g, B: int, bh: int, G: int,
                    params: OversegParams, include_temporal: bool):
    """Cross-band adjacency: per-slot min edges across the B-1 band seams.

    Returns a (D_bd, G+1) packed table in the `_extract_edges` layout.
    Crossing directions: spatial (dy=1, dx in {-1,0,1}) between the last
    row of band b and the first row of band b+1, plus — when flow is absent
    and t>1 — undisplaced temporal (dt=-1, dy=+-1, dx in {-1,0,1}).
    Flow-displaced temporal edges stay clamped within their band (a one-row
    approximation at each seam)."""
    t, h, w, nf = vol.shape
    nseg_g = G + 1
    bits, bshift = _pack_spec(nseg_g)
    pair_dist = _pair_dist_fn(params, nf)
    volr = vol.reshape(t, B, bh, w, nf)
    membr = memb_g.reshape(t, B, bh, w)
    lo_c = volr[:, :-1, -1]      # (t, B-1, w, 3): last row of band b
    hi_c = volr[:, 1:, 0]        # first row of band b+1
    lo_m = membr[:, :-1, -1]     # (t, B-1, w)
    hi_m = membr[:, 1:, 0]
    xs = jnp.arange(w)[None, None, :]

    def one(a_c, a_m, b_c, b_m, dx):
        if dx:
            b_c = jnp.roll(b_c, -dx, axis=2)
            b_m = jnp.roll(b_m, -dx, axis=2)
        valid = (xs + dx >= 0) & (xs + dx < w)
        d = pair_dist(a_c, b_c)
        bkt = jnp.minimum(_bucketize(d), NUM_BUCKETS - 2) >> bshift
        ok = valid & (a_m != G) & (b_m != G) & (a_m != b_m)
        pk_a = jnp.where(ok, (bkt << bits) | b_m, _I32MAX).reshape(-1)
        pk_b = jnp.where(ok, (bkt << bits) | a_m, _I32MAX).reshape(-1)
        e_a = jax.ops.segment_min(pk_a, a_m.reshape(-1),
                                  num_segments=nseg_g)
        e_b = jax.ops.segment_min(pk_b, b_m.reshape(-1),
                                  num_segments=nseg_g)
        return [e_a, e_b]

    cols = []
    for dx in (-1, 0, 1):
        cols += one(lo_c, lo_m, hi_c, hi_m, dx)
    if include_temporal and t > 1:
        for dx in (-1, 0, 1):
            # (t, lo row) -> (t-1, hi row): down-backward
            cols += one(lo_c[1:], lo_m[1:], hi_c[:-1], hi_m[:-1], dx)
            # (t, hi row) -> (t-1, lo row): up-backward
            cols += one(hi_c[1:], hi_m[1:], lo_c[:-1], lo_m[:-1], dx)
    return jnp.stack(cols, axis=0)


def _banded_dims(t: int, h: int, w: int, params: OversegParams):
    """Static band-decomposition geometry shared by the single-device and
    mesh-sharded banded solvers: (B, bh, cap_b, nseg_b, G, nseg_g)."""
    B = params.bands
    if h % B or (h // B) % 8:
        raise ValueError(f"height {h} not divisible into {B} bands of "
                         f"8-row-aligned height")
    bh = h // B
    n_band = t * bh * w
    cap_b = params.band_table_slots or min(
        max(n_band // params.table_divisor, 1 << 14), n_band)
    nseg_b = cap_b + 1
    G = B * cap_b
    nseg_g = G + 1
    _pack_spec(nseg_g)  # validate packability
    return B, bh, cap_b, nseg_b, G, nseg_g


def _banded_split_inputs(vol, fl, init_label, constr_init, frozen_init,
                         fin_init, params: OversegParams, cell_stats=None):
    """Band-split every per-pixel solver input: (tt,h,w[,C]) ->
    (B,tt,bh,w[,C]) with init labels localized to band-local voxel ids.
    Returns the band_fn argument tuple."""
    t, h, w, nf = vol.shape
    B, bh, _, _, _, _ = _banded_dims(t, h, w, params)

    def band_split(x, ch=0):
        tt = x.shape[0]
        shape = (tt, B, bh, w) + ((ch,) if ch else ())
        perm = (1, 0, 2, 3, 4) if ch else (1, 0, 2, 3)
        return x.reshape(shape).transpose(perm)

    vol_b = band_split(vol, nf)
    fl_b = (band_split(fl, 2) if fl is not None else
            jnp.zeros((B, max(t - 1, 0), bh, w, 2), jnp.float32))
    init_bs = band_split(init_label.reshape(t, h, w))
    # Localize init values (global voxel ids, in-band by construction) to
    # band-local voxel ids.
    band_of = jnp.arange(B, dtype=jnp.int32)[:, None, None, None]
    init_local = (init_bs // (h * w)) * (bh * w) \
        + (init_bs % (h * w) - band_of * (bh * w))
    constr_b = band_split(constr_init.reshape(t, h, w))
    frozen_b = band_split(frozen_init.reshape(t, h, w))
    fin_b = band_split(fin_init.reshape(t, h, w))
    if cell_stats is not None:
        cells_b = tuple(band_split(x.reshape(t, h, w)) for x in cell_stats)
    else:
        cells_b = tuple(jnp.zeros((B, 0)) for _ in range(4))
    return (vol_b, fl_b, init_local, constr_b, frozen_b, fin_b, cells_b,
            jnp.arange(B, dtype=jnp.int32))


def _make_band_fn(t: int, h: int, w: int, params: OversegParams,
                  has_flow: bool, use_cells: bool, has_constraints: bool,
                  head_planes: int):
    """Per-band pixel phase (seed compaction + edge extraction) of the
    banded solver — pure per-band function, mappable by lax.map / vmap on
    one device or shard_map over the mesh "space" axis (each device then
    runs only its own band; see parallel/mesh.py)."""
    B, bh, cap_b, nseg_b, G, nseg_g = _banded_dims(t, h, w, params)

    def band_fn(args):
        vb, flb, il, cb, fb, finb, cls, bidx = args
        cls_flat = (tuple(x.reshape(-1) for x in cls) if use_cells
                    else None)
        ts_b, memb_b, orig_b = _init_table(
            vb, il.reshape(-1), cb.reshape(-1), fb.reshape(-1),
            finb.reshape(-1), cap_b, has_constraints, params,
            cls_flat, head_planes)
        tab_b = _extract_edges(memb_b.reshape(t, bh, w), vb,
                               flb if has_flow else None, nseg_b, cap_b,
                               params, global_base=bidx * cap_b,
                               pack_domain=nseg_g)
        # Delocalize original-root voxel ids.
        orig_g = (orig_b // (bh * w)) * (h * w) + bidx * (bh * w) \
            + orig_b % (bh * w)
        gs = (ts_b.gsum if ts_b.gsum is not None
              else jnp.zeros((cap_b + 1, 2), jnp.float32))
        return (ts_b.csum, ts_b.size, ts_b.constr, ts_b.fin, ts_b.frozen,
                ts_b.sqsum, gs, memb_b, tab_b, orig_g)

    return band_fn


def _solve_banded(vol, fl, init_label, constr_init, frozen_init, fin_init,
                  params: OversegParams, thetas, level_rounds,
                  has_constraints, cell_stats=None, head_planes: int = 0,
                  band_outputs=None):
    """Row-banded pixel phases + global table phases (OversegParams.bands).

    Each band runs seed compaction and edge extraction independently
    (lax.map — one band resident at a time; vmap when bands_vmap), with
    its table slots mapped into a disjoint global range; a boundary pass
    restores cross-band adjacency; the schedule/min-size/constraint phases
    then run on the concatenated global table exactly as in the monolithic
    solve.  `band_outputs` lets a mesh caller (parallel/mesh.py) supply
    the band phase's results computed under shard_map (one band per
    device) — the global phases here are identical either way."""
    t, h, w, nf = vol.shape
    B, bh, cap_b, nseg_b, G, nseg_g = _banded_dims(t, h, w, params)
    sink_g = G
    has_flow = fl is not None

    if band_outputs is None:
        band_fn = _make_band_fn(t, h, w, params, has_flow,
                                cell_stats is not None, has_constraints,
                                head_planes)
        args = _banded_split_inputs(vol, fl, init_label, constr_init,
                                    frozen_init, fin_init, params,
                                    cell_stats)
        mapper = jax.vmap(band_fn) if params.bands_vmap else \
            functools.partial(jax.lax.map, band_fn)
        band_outputs = mapper(args)
    (csum_s, size_s, constr_s, fin_s, frozen_s, sqsum_s, gsum_s, memb_s,
     tab_s, orig_s) = band_outputs

    def glue(rows, sink_val, dtype=None):
        """(B, nseg_b, ...) per-band tables -> (G+1, ...) global."""
        flat = rows[:, :cap_b].reshape((G,) + rows.shape[2:])
        sink_row = jnp.full((1,) + rows.shape[2:], sink_val,
                            dtype or rows.dtype)
        return jnp.concatenate([flat, sink_row], axis=0)

    ts = SolverState(
        label=jnp.arange(nseg_g, dtype=jnp.int32),
        csum=glue(csum_s, 0.0), size=glue(size_s, 0.0),
        constr=glue(constr_s, -1), fin=glue(fin_s, 0),
        frozen=glue(frozen_s, False), sqsum=glue(sqsum_s, 0.0),
        gsum=glue(gsum_s, 0.0) if params.gradient_trait else None)
    orig_slot = glue(orig_s, 0)

    memb_g = jnp.where(memb_s == cap_b, sink_g,
                       memb_s + (jnp.arange(B, dtype=jnp.int32)
                                 * cap_b)[:, None])
    memb_g = memb_g.reshape(B, t, bh, w).transpose(1, 0, 2, 3).reshape(-1)

    tab_g = jnp.concatenate(
        [tab_s[:, :, :cap_b].transpose(1, 0, 2).reshape(tab_s.shape[1], G),
         jnp.full((tab_s.shape[1], 1), _I32MAX, jnp.int32)], axis=1)
    tab_bd = _boundary_edges(vol, memb_g.reshape(t, h, w), B, bh, G,
                             params, include_temporal=fl is None)
    tab = jnp.concatenate([tab_g, tab_bd], axis=0)

    return _finish_table_solve(ts, tab, memb_g, orig_slot, init_label,
                               (t, h, w), params, thetas, level_rounds,
                               has_constraints)


def oversegment(vol, flow=None, constraints=None, init_label=None,
                frozen=None, fin=None,
                params: OversegParams = OversegParams(),
                cell_stats=None, head_planes: int = 0) -> OversegResult:
    """Over-segment a chunk volume.

    Args:
      vol: (T,H,W,3) float32 smoothed BGR in [0,1].
      flow: optional (T-1,H,W,2) backward flow for frames 1..T-1.
      constraints: optional (T,H,W) int32 compact constraint ids (-1 free);
        callers map previous-chunk region ids to [0,C).
      init_label: optional (T,H,W) int32 initial labels (pre-merged
        constrained regions point at a canonical member voxel).
      frozen: optional (T,H,W) bool — voxels of already-emitted geometry
        (the reference's virtual nodes); their regions keep constraints and
        always merge with their constraint group.
      fin: optional (T,H,W) finalize levels (int: minimum bucket of a
        failed merge test, NUM_BUCKETS = open; merges admissible only at
        bucket < fin) or bool (True = blocked at every level).  Levels are
        what the tile pre-solve exports: under the reference's ascending
        edge order, "finalized" means no merges at weight >= the failing
        edge's weight (segmentation_graph.h:399-402), NOT at the
        lower weights it would already have merged.
      params: solver parameters.
      cell_stats: optional (size, c0, c1, c2) per-region sums, CELL-
        POSITIONED at root voxels ((T,H,W) f32 each, as
        tile_felzenszwalb exports) — table init then gathers per-slot
        stats from root cells instead of segment-summing pixels.
      head_planes: number of leading planes whose init labels are host-
        built constraint groups (no cell stats); those planes reduce from
        pixels.  Static under jit.

    Returns OversegResult; `label` holds arbitrary root-voxel ids (compact
    them on the host), `constr[root]` the surviving compact constraint id.
    """
    t, h, w, _ = vol.shape
    n = t * h * w
    if init_label is None:
        init_label = jnp.arange(n, dtype=jnp.int32)
    else:
        init_label = init_label.reshape(n).astype(jnp.int32)
    if constraints is None:
        constr_init = jnp.full(n, -1, jnp.int32)
        has_constraints = False
    else:
        constr_init = constraints.reshape(n).astype(jnp.int32)
        has_constraints = True
    if frozen is None:
        frozen_init = jnp.zeros(n, bool)
    else:
        frozen_init = frozen.reshape(n).astype(bool)
    if fin is None:
        fin_init = jnp.full(n, NUM_BUCKETS, jnp.int32)
    elif fin.dtype == jnp.bool_ or fin.dtype == bool:
        fin_init = jnp.where(fin.reshape(n), 0, NUM_BUCKETS).astype(jnp.int32)
    else:
        fin_init = fin.reshape(n).astype(jnp.int32)
    if params.descriptor != "color_mean" and not params.edge_table:
        raise ValueError("descriptor traits other than color_mean require "
                         "the edge-table solver (edge_table=True)")
    if params.gradient_trait and not params.edge_table:
        raise ValueError("the gradient trait requires the edge-table "
                         "solver (edge_table=True)")
    has_flow = flow is not None
    if flow is None:
        flow = jnp.zeros((max(t - 1, 0), h, w, 2), jnp.float32)
    return _solve(vol, flow, init_label, constr_init, frozen_init, fin_init,
                  params, has_flow, has_constraints, cell_stats,
                  head_planes)
