"""Batched hierarchical region agglomeration (device).

Replaces the reference's sequential lowest-edge-first agglomeration with
budgeted parallel merge rounds (RegionAgglomerationGraph::SegmentGraph,
region_segmentation_graph.cpp:73-177):

- Edge weights: SquaredOR(appearance chi^2, flow chi^2) scaled by the region
  size penalizer (re-evaluated per level; per subround in the small phases —
  see below).
- Each sub-round, every region proposes its minimum-weight incident edge;
  the globally smallest `budget` proposals merge simultaneously
  (direction-parity hooking, pointer jumping), so the merges per level match
  the reference's level cutoff (level size * (1 - cutoff),
  segmentation.cpp:305-389; level 0 cut to max_region_num).
- Region statistics (histograms, per-frame flow histograms/counts, sizes)
  merge with segment-sums.

Performance/quality structure — static *phases* of shrinking table size:
the hierarchy shrinks ~0.8x per level, but a single fused program would pay
raw-input-sized tables on every level.  Instead the level loop runs as a
sequence of statically-shaped phases (rcap, rcap/2, rcap/4, ... >= 1024);
when the active region count fits the next phase's table, live roots are
renumbered into it, statistics rows gathered, and the edge list deduplicated
into a smaller static table.  In the small phases (cap <= 1024 — the upper
hierarchy), distances are RE-EVALUATED every subround from freshly merged
statistics and the level budget is split across subrounds, closely
approximating the reference's re-evaluation after every single merge
(region_segmentation_graph.cpp:409-503), where frozen level-granular
distances caused the round-2 upper-hierarchy quality gap.

Everything still runs as ONE device program per chunk set (host syncs once).

Returns per-level root assignments over the original region index space;
callers compose them into parent/child hierarchies and remapped rasters.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.ops import cc, histograms as hops

_I32MAX = jnp.iinfo(jnp.int32).max
_DQ = 1 << 20  # distance quantization for integer keys


@functools.partial(jax.jit, static_argnames=("shape",))
def _scatter_table(keys, vals, shape: tuple):
    n = 1
    for s in shape:
        n *= s
    return jnp.zeros(n, jnp.float32).at[keys].add(vals).reshape(shape)


def _to_device_sparse(arr):
    """Upload a large mostly-empty host table as COO (int32 keys + f32
    values) and scatter it into shape on device: the dense histogram
    tables ((rcap, 4000) and friends) are mostly zeros, so this moves a
    fraction of their bytes to the device."""
    if not isinstance(arr, np.ndarray) or arr.size < (1 << 20):
        return jnp.asarray(arr)
    assert arr.size < 2 ** 31, "int32 COO keys"
    flat = arr.reshape(-1)
    nz = np.flatnonzero(flat)
    if nz.size * 2 >= arr.size // 2:   # dense enough: COO wouldn't help
        return jnp.asarray(arr)
    cap = max(1 << 14, _next_pow2(nz.size))  # quantized: few programs
    keys = np.zeros(cap, np.int32)
    keys[:nz.size] = nz
    vals = np.zeros(cap, np.float32)
    vals[:nz.size] = flat[nz]
    return _scatter_table(jnp.asarray(keys), jnp.asarray(vals),
                          tuple(arr.shape))


class AggloState(NamedTuple):
    label: jnp.ndarray      # (C,) slot -> current root (C = phase cap)
    hist: jnp.ndarray       # (C,B) color histograms (unnormalized)
    flow_hist: jnp.ndarray  # (T,C,FB)
    flow_cnt: jnp.ndarray   # (T,C)
    sizes: jnp.ndarray      # (C,) f32
    win_hist: jnp.ndarray   # (NW,C,B) windowed appearance (NW=0: unused)
    win_cnt: jnp.ndarray    # (NW,C)


def _eval_distances(state: AggloState, edges, evalid, inv_median, use_flow,
                    penalizer):
    ra = state.label[edges[:, 0]]
    rb = state.label[edges[:, 1]]
    pairs = jnp.stack([ra, rb], axis=1)
    if state.win_hist.shape[0] > 0:
        # WindowedAppearanceDescriptor replaces the single-histogram
        # appearance distance (region_descriptor.cpp:207-276).
        color_d = hops.edge_color_distance_windowed(state.win_hist,
                                                    state.win_cnt, pairs)
    else:
        color_d = hops.edge_color_distance(state.hist, pairs)
    if state.flow_hist.shape[0] > 0:
        flow_d = hops.edge_flow_distance(state.flow_hist, state.flow_cnt,
                                         pairs)
    else:
        flow_d = jnp.zeros_like(color_d)
    # use_flow as a multiplier: disabled flow contributes distance 0.
    d = hops.combined_distance(color_d, flow_d * use_flow, state.sizes[ra],
                               state.sizes[rb], inv_median,
                               penalizer=penalizer, use_flow=True)
    return jnp.where(evalid & (ra != rb), d, jnp.inf)


def _kth_smallest(key, budget):
    """Value of the `budget`-th smallest element of int32 `key` (1-based;
    entries in [0,_DQ] or _I32MAX), via a two-pass radix histogram select —
    identical to sort()[budget-1] at a fraction of the cost (the per-
    subround full sort dominated agglomeration time)."""
    n = key.shape[0]
    budget = jnp.clip(budget, 1, n)
    coarse = jnp.minimum(key >> 10, (_DQ >> 10) + 1)    # invalid -> last bin
    nb = (_DQ >> 10) + 2
    c1 = jnp.cumsum(jnp.zeros(nb, jnp.int32).at[coarse].add(1))
    b = jnp.searchsorted(c1, budget, side="left").astype(jnp.int32)
    rank = budget - jnp.where(b > 0, c1[jnp.maximum(b - 1, 0)], 0)
    fine = jnp.where(coarse == b, key & 1023, 1024)
    c2 = jnp.cumsum(jnp.zeros(1025, jnp.int32).at[fine].add(1))
    f = jnp.searchsorted(c2, rank, side="left").astype(jnp.int32)
    return jnp.where(b > (_DQ >> 10), _I32MAX, (b << 10) | f)


def _label_subround(label, edges, d, budget, up):
    """One label-only merge subround over frozen distances d."""
    r = label.shape[0]
    ra = label[edges[:, 0]]
    rb = label[edges[:, 1]]
    act = jnp.isfinite(d) & (ra != rb)
    key = jnp.where(act, jnp.clip((d * _DQ).astype(jnp.int32), 0, _DQ),
                    _I32MAX)

    # Per-region minimum proposal (both endpoints see the edge).
    seg = jnp.concatenate([ra, rb])
    k2 = jnp.concatenate([key, key])
    partner2 = jnp.concatenate([rb, ra])
    best = jax.ops.segment_min(k2, seg, num_segments=r)
    at_min = (k2 == best[seg]) & (k2 < _I32MAX)
    p2 = jnp.where(at_min, partner2, _I32MAX)
    partner = jax.ops.segment_min(p2, seg, num_segments=r)

    # Keep only the globally smallest `budget` proposals.
    kth = _kth_smallest(jnp.where(partner < _I32MAX, best, _I32MAX), budget)
    admit = ((partner < _I32MAX) & (best <= kth) & (best < _I32MAX)
             & (budget > 0))

    slots = jnp.arange(r, dtype=jnp.int32)
    hook = admit & ((partner > slots) == up)
    parent = jnp.where(hook, partner, slots)
    root = cc.pointer_jump(parent)
    moved = jnp.sum(root != slots)
    return root[label], moved


def _reaggregate(state: AggloState) -> AggloState:
    """Re-aggregate every statistics table onto current roots (slot s's
    live stats move to label[s])."""
    r = state.label.shape[0]
    seg = state.label
    hist = jax.ops.segment_sum(state.hist, seg, num_segments=r)
    fh = jax.vmap(lambda x: jax.ops.segment_sum(x, seg, num_segments=r),
                  in_axes=0, out_axes=0)(state.flow_hist)
    fc = jax.vmap(lambda x: jax.ops.segment_sum(x, seg, num_segments=r),
                  in_axes=0, out_axes=0)(state.flow_cnt)
    sizes = jax.ops.segment_sum(state.sizes, seg, num_segments=r)
    wh = jax.vmap(lambda x: jax.ops.segment_sum(x, seg, num_segments=r),
                  in_axes=0, out_axes=0)(state.win_hist)
    wc2 = jax.vmap(lambda x: jax.ops.segment_sum(x, seg, num_segments=r),
                   in_axes=0, out_axes=0)(state.win_cnt)
    return AggloState(state.label, hist, fh, fc, sizes, wh, wc2)


def _force_constraints(label, constr, b2c):
    """Force-merge current roots whose base members share a counterpart
    constraint (the reference's skeleton virtual edges,
    region_segmentation_graph.cpp:52-71).  `constr` is per BASE region
    (-1 = unconstrained); `b2c` maps base regions to current slots;
    `label` is (cap,) slot -> root.

    Hooks every constrained root onto the minimum root carrying its
    constraint — strictly downward, hence acyclic.  A root whose members
    carry two different constraint ids hooks only toward one rep per pass,
    so the pass iterates to a fixed point (the reference's skeleton edges
    union transitively); the per-constraint minimum root only decreases,
    so it converges."""
    cap = label.shape[0]
    rcap = constr.shape[0]
    slots = jnp.arange(cap, dtype=jnp.int32)
    has_c = constr >= 0
    cid = jnp.clip(constr, 0, rcap - 1)

    def one_pass(lab):
        root_b = lab[b2c]                     # (rcap,) current root per base
        rep = jax.ops.segment_min(jnp.where(has_c, root_b, _I32MAX), cid,
                                  num_segments=rcap)
        tgt = jnp.where(has_c, rep[cid], _I32MAX)
        partner = jax.ops.segment_min(
            jnp.where(has_c & (tgt != root_b), tgt, _I32MAX), root_b,
            num_segments=cap)
        hook = (partner < _I32MAX) & (partner < slots)
        parent = jnp.where(hook, partner, slots)
        lab2 = cc.pointer_jump(parent)[lab]
        return lab2, jnp.any(lab2 != lab)

    def cond(carry):
        _, changed, i = carry
        return changed & (i < 32)

    def body(carry):
        lab, _, i = carry
        lab2, changed = one_pass(lab)
        return lab2, changed, i + 1

    label, _, _ = jax.lax.while_loop(
        cond, body, (label, jnp.bool_(True), jnp.int32(0)))
    return label


def _level_step(state: AggloState, edges, evalid, constr, b2c, is_level0,
                max_region_num, min_region_num, cutoff_fraction, use_flow,
                penalizer, max_subrounds: int, reeval: bool):
    """One hierarchy level.  With `reeval` (static), region statistics are
    re-aggregated and edge distances re-evaluated at every subround and the
    level budget is split across subrounds — the fine-grained approximation
    of the reference's per-merge re-evaluation; otherwise distances are
    frozen for the level (cheap, used while region counts are large)."""
    cap = state.label.shape[0]
    rcap = constr.shape[0]
    slots = jnp.arange(cap, dtype=jnp.int32)
    active_mask = (state.label == slots) & (state.sizes > 0)
    active = jnp.sum(active_mask.astype(jnp.int32))

    cut_target = jnp.where(
        is_level0 & (active > max_region_num), max_region_num,
        jnp.maximum(min_region_num,
                    (active.astype(jnp.float32)
                     * cutoff_fraction).astype(jnp.int32)))
    # Anticipated forced constraint merges come out of the budget
    # (segmentation.cpp:316-330: target merges minus constraint merges).
    has_c = constr >= 0
    cid = jnp.clip(constr, 0, rcap - 1)
    root_b = state.label[b2c]
    n_croots = jnp.sum(jax.ops.segment_max(
        has_c.astype(jnp.int32), jnp.where(has_c, root_b, 0),
        num_segments=cap))
    n_cids = jnp.sum(jax.ops.segment_max(
        has_c.astype(jnp.int32), cid, num_segments=rcap))
    anticipated = jnp.maximum(n_croots - n_cids, 0)
    budget_total = jnp.maximum(active - cut_target - anticipated, 0)

    sz_sorted = jnp.sort(jnp.where(active_mask, state.sizes, jnp.inf))
    median = sz_sorted[jnp.clip(active // 2, 0, cap - 1)]
    inv_median = 1.0 / jnp.maximum(median, 1.0)

    if reeval:
        def body(k, carry):
            label, merged = carry
            st_k = _reaggregate(state._replace(label=label))
            d = _eval_distances(st_k, edges, evalid, inv_median, use_flow,
                                penalizer)
            remaining = budget_total - merged
            rem_rounds = max_subrounds - k
            quota = (remaining + rem_rounds - 1) // rem_rounds
            label, moved = _label_subround(label, edges, d, quota,
                                           (k % 2) == 0)
            return label, merged + moved

        label, _ = jax.lax.fori_loop(0, max_subrounds, body,
                                     (state.label, jnp.int32(0)))
    else:
        d = _eval_distances(state, edges, evalid, inv_median, use_flow,
                            penalizer)

        def body(k, carry):
            label, merged, dd = carry
            label, moved = _label_subround(label, edges, dd,
                                           budget_total - merged,
                                           (k % 2) == 0)
            ra = label[edges[:, 0]]
            rb = label[edges[:, 1]]
            dd = jnp.where(ra != rb, dd, jnp.inf)
            return label, merged + moved, dd

        label, _, _ = jax.lax.fori_loop(
            0, max_subrounds, body, (state.label, jnp.int32(0), d))

    label = _force_constraints(label, constr, b2c)
    state = _reaggregate(state._replace(label=label))
    active_after = jnp.sum(((state.label == slots)
                            & (state.sizes > 0)).astype(jnp.int32))
    return state, active_after


def _compact_phase(state: AggloState, b2c, c2o, edges, evalid,
                   new_cap: int, new_ecap: int):
    """Renumber live roots into a fresh table of `new_cap` slots, gather
    statistics rows, and deduplicate the edge list into `new_ecap` rows.
    Caller guarantees the active count fits `new_cap`."""
    old_cap = state.label.shape[0]
    root = state.label
    slots = jnp.arange(old_cap, dtype=jnp.int32)
    is_root = (root == slots) & (state.sizes > 0)
    cidx_all = jnp.cumsum(is_root.astype(jnp.int32)) - 1
    ok = is_root & (cidx_all < new_cap)
    cidx = jnp.where(ok, cidx_all, new_cap - 1)
    n_active = jnp.sum(ok.astype(jnp.int32))

    inv = jnp.zeros(new_cap, jnp.int32).at[
        jnp.where(ok, cidx_all, 0)].max(jnp.where(ok, slots, 0))
    valid_new = jnp.arange(new_cap, dtype=jnp.int32) < n_active
    vf = valid_new.astype(jnp.float32)

    hist = state.hist[inv] * vf[:, None]
    fh = state.flow_hist[:, inv] * vf[None, :, None]
    fc = state.flow_cnt[:, inv] * vf[None, :]
    sizes = state.sizes[inv] * vf
    wh = state.win_hist[:, inv] * vf[None, :, None]
    wc = state.win_cnt[:, inv] * vf[None, :]
    new_state = AggloState(jnp.arange(new_cap, dtype=jnp.int32), hist, fh,
                           fc, sizes, wh, wc)

    b2c_new = cidx[root[b2c]]
    c2o_new = c2o[inv]

    # Edge dedup: map endpoints through the renumbering, canonicalize,
    # sort packed keys, keep first occurrences, compact to the front.
    ea = cidx[root[edges[:, 0]]]
    eb = cidx[root[edges[:, 1]]]
    lo = jnp.minimum(ea, eb)
    hi = jnp.maximum(ea, eb)
    valid = evalid & (lo != hi)
    key = jnp.where(valid, lo * new_cap + hi, _I32MAX)
    key_s = jnp.sort(key)
    first = jnp.concatenate([jnp.ones(1, bool), key_s[1:] != key_s[:-1]])
    key_u = jnp.sort(jnp.where(first, key_s, _I32MAX))[:new_ecap]
    evalid_new = key_u < _I32MAX
    ea2 = jnp.where(evalid_new, key_u // new_cap, 0)
    eb2 = jnp.where(evalid_new, key_u % new_cap, 0)
    edges_new = jnp.stack([ea2, eb2], axis=1)
    return new_state, b2c_new, c2o_new, edges_new, evalid_new


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _phase_specs(rcap: int, ecap: int, reeval_cap: int, floor: int,
                 edge_degree: int) -> tuple:
    """Static (cap, edge_cap, reeval) per phase: halving caps down to the
    floor; edge tables sized cap*edge_degree (phase 0 keeps the input).

    Small problems (rcap <= 2048 — unit tests, tiny clips) run as a single
    re-evaluating phase: the multi-phase structure would multiply compile
    time for no runtime win at that size."""
    if rcap <= 2048:
        return ((rcap, ecap, True),)
    caps = [rcap]
    while caps[-1] // 2 >= floor:
        caps.append(caps[-1] // 2)
    specs = []
    for i, c in enumerate(caps):
        e = ecap if i == 0 else min(ecap, _next_pow2(c * edge_degree))
        specs.append((c, e, c <= reeval_cap))
    return tuple(specs)


@functools.partial(jax.jit, static_argnames=("max_subrounds", "max_levels",
                                             "phases"))
def _run_all_levels(state: AggloState, edges, evalid, constr_stack,
                    max_region_num, min_region_num, cutoff_fraction,
                    use_flow, penalizer, max_subrounds: int,
                    max_levels: int, phases: tuple):
    """Every hierarchy level in ONE device program (no per-level host
    round-trips), structured as static
    shrinking phases.  Levels past convergence degenerate to no-ops; the
    host trims them from the result."""
    rcap = state.label.shape[0]
    slots0 = jnp.arange(rcap, dtype=jnp.int32)
    active = jnp.sum(((state.label == slots0)
                      & (state.sizes > 0)).astype(jnp.int32))
    labels_out = jnp.zeros((max_levels, rcap), jnp.int32)
    actives = jnp.zeros(max_levels, jnp.int32)
    b2c = slots0
    c2o = slots0
    l = jnp.int32(0)

    for p, (cap, ecap_p, reeval) in enumerate(phases):
        if p > 0:
            with jax.named_scope(f"agglo_compact_to_{cap}"):
                state, b2c, c2o, edges, evalid = _compact_phase(
                    state, b2c, c2o, edges, evalid, cap, ecap_p)
        # Continue in this phase while the hierarchy is unfinished and the
        # active count does not yet fit the next (smaller) phase.
        next_cap = phases[p + 1][0] if p + 1 < len(phases) else 0

        def cond(carry):
            st, lo, ac, li, a, b2, c2, ed, ev = carry
            go = (li < max_levels) & (a > min_region_num)
            if next_cap:
                go = go & (a >= next_cap)
            return go

        def body(carry):
            st, lo, ac, li, a, b2, c2, ed, ev = carry
            st, a2 = _level_step(
                st, ed, ev, constr_stack[li], b2, li == 0, max_region_num,
                min_region_num, cutoff_fraction, use_flow, penalizer,
                max_subrounds, reeval)
            full = c2[st.label[b2]]
            lo = jax.lax.dynamic_update_slice(lo, full[None], (li, 0))
            ac = ac.at[li].set(a2)
            return st, lo, ac, li + 1, a2, b2, c2, ed, ev

        (state, labels_out, actives, l, active, b2c, c2o, edges,
         evalid) = jax.lax.while_loop(
            cond, body,
            (state, labels_out, actives, l, active, b2c, c2o, edges,
             evalid))
    return labels_out, actives


def agglomerate(hist, flow_hist, flow_cnt, sizes, edges, num_regions: int,
                *, min_region_num: int = 10, max_region_num: int = 10000,
                cutoff_fraction: float = 0.8, penalizer: float = 0.25,
                use_flow: bool = True, max_subrounds: int = 6,
                constraints=None, win_hist=None, win_cnt=None,
                reeval_cap: int = 1024, phase_floor: int = 256,
                edge_degree: int = 16):
    """Run the full level loop; returns list of per-level (R,) root arrays.

    Regions with index >= num_regions must be padding (zero stats); their
    labels stay self and they never merge (no edges reference them).

    `constraints`: optional list of per-level (R,) int32 arrays of compact
    counterpart constraint ids over BASE regions (-1 free).  At level l all
    regions carrying the same constraints[l] id are force-merged, keeping
    hierarchy composition continuous across chunk-set seams
    (region_segmentation.cpp:143-197).
    """
    r = hist.shape[0]
    if win_hist is None:
        win_hist = np.zeros((0, r, hist.shape[1]), np.float32)
        win_cnt = np.zeros((0, r), np.float32)
    state = AggloState(jnp.arange(r, dtype=jnp.int32),
                       _to_device_sparse(hist),
                       _to_device_sparse(flow_hist), jnp.asarray(flow_cnt),
                       jnp.asarray(sizes, jnp.float32),
                       _to_device_sparse(win_hist), jnp.asarray(win_cnt))
    edges = jnp.asarray(edges, jnp.int32)
    if edges.shape[0] == 0:
        edges = jnp.zeros((1, 2), jnp.int32)  # inert self-edge
    ecap = int(edges.shape[0])
    evalid = jnp.ones(ecap, bool)

    use_flow_f = jnp.float32(1.0 if use_flow else 0.0)

    max_levels = 40  # hierarchies top out around 25-35 levels
    constr_stack = np.full((max_levels, r), -1, np.int32)
    if constraints is not None:
        for l in range(min(len(constraints), max_levels)):
            constr_stack[l] = constraints[l]

    phases = _phase_specs(r, ecap, reeval_cap=reeval_cap,
                          floor=min(phase_floor, r),
                          edge_degree=edge_degree)
    labels_out, actives = _run_all_levels(
        state, edges, evalid, jnp.asarray(constr_stack),
        jnp.int32(max_region_num), jnp.int32(min_region_num),
        jnp.float32(cutoff_fraction), use_flow_f, jnp.float32(penalizer),
        max_subrounds, max_levels, phases)
    labels_out = np.asarray(labels_out)
    actives = np.asarray(actives)

    import os
    levels = []
    active = num_regions
    for l in range(max_levels):
        if active <= min_region_num:
            break
        new_active = int(actives[l])
        if new_active == 0:
            break  # device loop terminated before this level
        if new_active >= active:
            break  # no progress (disconnected remainder)
        if os.environ.get("VST_VERBOSE"):
            import sys
            print(f"[stats] agglomeration level {l}: {active} -> "
                  f"{new_active} regions", file=sys.stderr, flush=True)
        active = new_active
        levels.append(labels_out[l].copy())
    return levels
