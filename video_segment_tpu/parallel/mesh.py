"""Device-mesh sharding of the segmentation compute path.

Multi-device strategy (the reference is single-process shared-memory,
SURVEY §2.7; this is the scale-out design over a device mesh):

- "data" axis: clip/chunk parallelism — each chip segments different clips
  or different chunk batches (the production serving topology).
- "space" axis: frame rows.  The pixel front-end (presmoothing, edge
  weights, TV-L1 iterations) shards with ppermute halo exchange; the
  SOLVER shards through its row-band decomposition
  (`OversegParams.bands` + `bands_vmap`, `sharded_oversegment` below):
  each device runs the pixel phases (seed compaction, edge extraction) of
  its own band, and the O(regions) global table phases run on the
  all-gathered band tables — the expensive O(pixels) work never leaves
  its shard.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(n_devices: int | None = None, data: int | None = None,
              space: int | None = None) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devs)
    if data is None or space is None:
        # Favor spatial sharding within a clip, data across clips.
        space = min(4, n)
        while n % space:
            space -= 1
        data = n // space
    return Mesh(np.asarray(devs).reshape(data, space), ("data", "space"))


def halo_exchange_rows(x: jnp.ndarray, axis_name: str = "space",
                       halo: int = 1, border: str = "edge") -> jnp.ndarray:
    """Pad a row-sharded (..., Hs, W, C) block with `halo` rows from its
    mesh neighbors.  At the outer mesh boundary the fill matches the
    downstream filter's border mode: "edge" (BORDER_REPLICATE) or
    "reflect" (reflect-101), so shard outputs equal single-chip outputs."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    top = x[..., :halo, :, :]
    bot = x[..., -halo:, :, :]
    from_prev = jax.lax.ppermute(bot, axis_name,
                                 [(i, (i + 1) % n) for i in range(n)])
    from_next = jax.lax.ppermute(top, axis_name,
                                 [(i, (i - 1) % n) for i in range(n)])
    if border == "reflect":
        top_fill = jnp.flip(x[..., 1:halo + 1, :, :], axis=-3)
        bot_fill = jnp.flip(x[..., -halo - 1:-1, :, :], axis=-3)
    else:  # edge: the border row repeated, as BORDER_REPLICATE does
        top_fill = jnp.repeat(x[..., :1, :, :], halo, axis=-3)
        bot_fill = jnp.repeat(x[..., -1:, :, :], halo, axis=-3)
    from_prev = jnp.where(idx == 0, top_fill, from_prev)
    from_next = jnp.where(idx == n - 1, bot_fill, from_next)
    return jnp.concatenate([from_prev, x, from_next], axis=-3)


def sharded_presmooth(mesh: Mesh, mode: str = "bilateral", halo: int = 4):
    """pjit-ed presmoothing over (B,T,H,W,3): B on "data", H on "space".

    The halo supplies true neighbor rows; the filter's own border padding
    only touches rows that are cropped away, so shard outputs match the
    single-chip filter exactly away from numerical noise."""
    from video_segment_tpu.ops import filters

    border = "reflect" if mode == "gaussian" else "edge"

    def shard_fn(block):  # (Bs, T, Hs, W, 3)
        padded = halo_exchange_rows(block, "space", halo, border)

        def one(img):
            out = filters.presmooth(img, mode)
            return out[halo:-halo] if halo else out

        return jax.vmap(jax.vmap(one))(padded)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=P("data", None, "space", None, None),
                       out_specs=P("data", None, "space", None, None))
    return jax.jit(fn)


def _free_solve_one(params, has_flow):
    """Per-clip unconstrained solve closure shared by the fused and
    mesh-sharded multi-clip paths: (T,H,W,3) [+(T-1,H,W,2) flow] ->
    (T,H,W) int32 labels via the edge-table solver."""
    from video_segment_tpu.core import oversegmentation as ov

    def solve_one(vol, flow):
        t, h, w, _ = vol.shape
        n = t * h * w
        return ov._solve(vol, flow, jnp.arange(n, dtype=jnp.int32),
                         jnp.full(n, -1, jnp.int32), jnp.zeros(n, bool),
                         jnp.full(n, ov.NUM_BUCKETS, jnp.int32), params,
                         has_flow, False).label

    return solve_one


def fused_oversegment(params=None, has_flow: bool = False,
                      max_solve_voxels: int = 8_000_000):
    """Single-device fused multi-clip over-segmentation: ONE compiled
    program solves a whole batch of clips (vmap over the leading clip
    axis), instead of serializing per-clip programs on the chip.

    Returns fn(vols, flows) for vols (clips, T, H, W, 3) [flows
    (clips, T-1, H, W, 2)] -> (clips, T, H, W) int32 labels, equal
    per clip to the single-clip solve (vmap only batches; the math is
    per-clip — equality-tested on the CPU mesh, tests/test_parallel.py).
    This is the device-side half of BASELINE config 5's batch topology —
    host stages (RLE, histograms, proto emission) stay per-clip and
    overlap via tools/batch_segment --concurrent; multi-chip batch rides
    the mesh "data" axis (`sharded_oversegment`).

    The batched program's live solve footprint is clips * T * H * W
    voxels: calls whose batch exceeds `max_solve_voxels` are rejected up
    front rather than running out of device memory mid-solve.  Callers
    should also pad the clip axis to a canonical batch size (the compiled
    shape includes it, so every distinct batch size is a fresh compile)."""
    from video_segment_tpu.core import oversegmentation as ov

    p = (params or ov.OversegParams())._replace(edge_table=True)
    vm = jax.jit(jax.vmap(_free_solve_one(p, has_flow)))

    def fn(vols, flows=None):
        b, t, h, w = vols.shape[:4]
        if b * t * h * w > max_solve_voxels:
            raise ValueError(
                f"batched solve footprint {b}x{t}x{h}x{w} = "
                f"{b * t * h * w} voxels exceeds max_solve_voxels "
                f"({max_solve_voxels}); shrink the batch or route clips "
                f"through the banded/streaming path")
        return vm(vols, flows)

    return fn


def _solve_schedule(params):
    """(thetas, level_rounds) int32 arrays for params.schedule — the same
    construction core/oversegmentation._solve performs."""
    import jax.numpy as jnp

    thetas = jnp.asarray(params.schedule, jnp.int32)
    lr = jnp.asarray(
        [params.max_rounds_per_level] * (len(params.schedule) - 1)
        + [params.max_final_rounds], jnp.int32)
    return thetas, lr


def sharded_chunk_solver(mesh: Mesh, params, has_flow: bool,
                         has_constraints: bool, head_planes: int,
                         use_cells: bool):
    """jit-ed CONSTRAINED streaming chunk solve for one clip, with the
    solver's row-band dimension sharded over the mesh "space" axis.

    This is the multi-chip form of the driver's per-chunk solve
    (core/dense.py:_segment_chunk): the O(pixels) band phase (seed
    compaction + edge extraction) runs under shard_map — each device
    executes exactly its own band's computation, locally and unpartitioned
    — and the O(regions) global table phases run replicated on the
    all-gathered band tables.  shard_map (not whole-program GSPMD
    partitioning) is deliberate: the solver's scatter/segment-op bodies
    must run with device-local semantics so the mesh result equals the
    single-device banded solve bit-for-bit; auto-partitioning them invites
    reassociation and partitioned-scatter divergence.  `params` must
    already carry bands == space axis size (DenseSegmentation(mesh=...)
    arranges this).

    Returns fn(vol, flow, init, constr, frozen, fin, cells4) ->
    OversegResult, CPU-mesh equality-tested against the single-device
    banded solve (tests/test_parallel.py, __graft_entry__ dryrun).
    """
    from jax.sharding import NamedSharding

    from video_segment_tpu.core import oversegmentation as ov

    thetas, lr = _solve_schedule(params)
    rep = NamedSharding(mesh, P())

    def solve(vol, flow, init, constr, frozen, fin, cells):
        if params.gradient_trait:
            from video_segment_tpu.ops import pixel_distance as pd
            vol = jnp.concatenate([vol, pd.gradient_features(vol)], axis=-1)
        t, h, w, _ = vol.shape
        n = t * h * w
        init_f = init.reshape(n)
        constr_f = constr.reshape(n)
        frozen_f = frozen.reshape(n)
        fin_f = fin.reshape(n)
        cells_f = (tuple(c.reshape(n) for c in cells) if use_cells
                   else None)
        fl = flow if has_flow else None
        band_fn = ov._make_band_fn(t, h, w, params, has_flow, use_cells,
                                   has_constraints, head_planes)
        args = ov._banded_split_inputs(vol, fl, init_f, constr_f, frozen_f,
                                       fin_f, params, cells_f)
        # check_vma off: band_fn is purely device-local (no collectives);
        # its internal scan carries start as unvarying constants, which the
        # varying-axes checker would otherwise reject.
        shmapped = jax.shard_map(jax.vmap(band_fn), mesh=mesh,
                                 in_specs=P("space"), out_specs=P("space"),
                                 check_vma=False)
        outs = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, rep),
            shmapped(args))
        return ov._solve_banded(vol, fl, init_f, constr_f, frozen_f, fin_f,
                                params, thetas, lr, has_constraints,
                                cells_f, head_planes, band_outputs=outs)

    return jax.jit(solve)


def sharded_oversegment(mesh: Mesh, params=None, has_flow: bool = False):
    """jit-ed over-segmentation with clips on "data" and the solver's
    row-band dimension on "space".

    Band phases run under shard_map over ("data", "space") — one clip-band
    per device, device-local scatter semantics (see sharded_chunk_solver's
    rationale) — then each clip's global table phases run vmapped with the
    clip axis sharded over "data" (a pure batch dimension, safely
    partitionable).

    Returns fn(vol, flow) for vol (clips, T, H, W, 3) [flow
    (clips, T-1, H, W, 2)] -> (clips, T, H, W) int32 labels.  clips must
    equal the "data" axis size; H must split into `space` bands of
    8-aligned height.  Labels are identical to the single-device banded
    solve (the band decomposition, not the mesh, defines the math).
    """
    from jax.sharding import NamedSharding

    from video_segment_tpu.core import oversegmentation as ov

    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    p = (params or ov.OversegParams())._replace(
        bands=axes["space"], bands_vmap=True, edge_table=True)
    thetas, lr = _solve_schedule(p)
    dspec = NamedSharding(mesh, P("data"))

    def solve(vols, flows):
        if p.gradient_trait:
            from video_segment_tpu.ops import pixel_distance as pd
            vols = jnp.concatenate(
                [vols, jax.vmap(pd.gradient_features)(vols)], axis=-1)
        b, t, h, w, _ = vols.shape
        n = t * h * w
        band_fn = ov._make_band_fn(t, h, w, p, has_flow, False, False, 0)

        def split_one(vol, flow):
            return ov._banded_split_inputs(
                vol, flow if has_flow else None,
                jnp.arange(n, dtype=jnp.int32), jnp.full(n, -1, jnp.int32),
                jnp.zeros(n, bool), jnp.full(n, ov.NUM_BUCKETS, jnp.int32),
                p, None)

        args = jax.vmap(split_one)(vols, flows)   # (b, B, ...) leaves
        shmapped = jax.shard_map(jax.vmap(jax.vmap(band_fn)), mesh=mesh,
                                 in_specs=P("data", "space"),
                                 out_specs=P("data", "space"),
                                 check_vma=False)
        outs = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, dspec),
            shmapped(args))

        def finish_one(vol, flow, out):
            return ov._solve_banded(
                vol, flow if has_flow else None,
                jnp.arange(n, dtype=jnp.int32), jnp.full(n, -1, jnp.int32),
                jnp.zeros(n, bool), jnp.full(n, ov.NUM_BUCKETS, jnp.int32),
                p, thetas, lr, False, None, 0, band_outputs=out).label

        return jax.vmap(finish_one)(vols, flows, outs)

    return jax.jit(solve, out_shardings=NamedSharding(
        mesh, P("data", None, "space", None)))
