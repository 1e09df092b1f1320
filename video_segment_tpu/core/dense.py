"""Streaming chunked dense over-segmentation driver.

Host-side equivalent of the reference's DenseSegmentation
(dense_segmentation.{h,cpp}): buffers preprocessed frames, runs the device
over-segmentation solver per chunk, assigns globally consistent region ids
across chunks, and emits per-frame RLE results plus a level-0 hierarchy per
chunk.

Chunk streaming protocol (dense_segmentation.cpp:100-431):
- A chunk solve covers the buffered frames.  With overlap 2 / 1 constraint
  frame, output covers local frames [chunk_start, last_output] where
  last_output = len(buffer) - overlap (all frames when flushing).
- The next chunk's buffer starts with the last output frame (plane 0,
  re-fed as *frozen* pre-merged regions — the role of the reference's
  virtual nodes) and the first lookahead frame (plane 1, per-pixel
  constrained), both carrying the previous chunk's global region ids as
  constraints.
- Ids: constrained regions that survive keep their previous global id;
  new regions get ids from a monotonically increasing counter
  (AssignUniqueRegionIds, segmentation.cpp:549-582).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.core import oversegmentation as ov
from video_segment_tpu.core.options import DenseSegmentationOptions
from video_segment_tpu.ops import filters, rle


@dataclasses.dataclass
class HierarchyLevelData:
    """One hierarchy level, arrays indexed per region (global ids)."""
    ids: np.ndarray           # (R,) int64, ascending
    sizes: np.ndarray         # (R,) int64 (window-adjusted voxel counts)
    start_frames: np.ndarray  # (R,) global video frame index
    end_frames: np.ndarray
    neighbor_pairs: np.ndarray  # (P,2) int64 global-id pairs, a<b
    parent_ids: np.ndarray | None = None   # (R,) or None (top level)
    child_pairs: np.ndarray | None = None  # (C,2) (parent_gid, child_gid)


@dataclasses.dataclass
class SegFrame:
    """Per-frame segmentation result (host representation of
    SegmentationDesc; serialized by dataio.fast_proto)."""
    frame_width: int
    frame_height: int
    region_ids: np.ndarray        # (R,) ascending global ids in this frame
    interval_counts: np.ndarray   # (R,)
    ys: np.ndarray
    lxs: np.ndarray
    rxs: np.ndarray
    chunk_size: int = 0
    overlap_start: int = 0
    chunk_id: int = -1
    hierarchy_frame_idx: int = 0
    hierarchy: list[HierarchyLevelData] | None = None  # chunk-start frame only
    frame_index: int = -1         # global video frame index
    moments: np.ndarray | None = None  # (R,6) ShapeMoments rows


@functools.partial(jax.jit, static_argnames=("h", "fix_n4"))
def _finalize_labels(lab: jnp.ndarray, h: int, fix_n4: bool):
    """Slice pad rows off the solver's label volume and resolve N4
    checkerboard diagonal crossings ON DEVICE (the reference's
    EnforceN4Connectivity, dense_segmentation_graph.h:1303-1337): one
    vectorized stencil pass, bitwise-equal to ops/rle.enforce_n4_connectivity
    per frame, moved off the host where it cost a serial pass over the
    volume on the inter-chunk critical path.  Pad rows must be sliced
    BEFORE the stencil — a replicated bottom row would fire the crossing
    pattern along the entire true bottom edge."""
    lab = lab[:, :h]
    if not fix_n4:
        return lab
    a = lab[:, :-1, :-1]
    b = lab[:, :-1, 1:]
    c = lab[:, 1:, :-1]
    d = lab[:, 1:, 1:]
    cross = (a == d) & (b == c) & (a != b)
    flip = jnp.pad(cross, ((0, 0), (0, 1), (0, 1)))
    right = jnp.concatenate([lab[:, :, 1:], lab[:, :, -1:]], axis=2)
    return jnp.where(flip, right, lab)


def _materialize_solve_inputs(prep: dict, w: int):
    """Materialize a `_prepare_chunk` dict's optional solver inputs to
    their neutral full volumes, so one compiled signature covers a whole
    chunk class.  Shared by the mesh dispatch (sharded_chunk_solver) and
    the fused multi-clip batch driver (core/batch.py), whose programs
    cannot branch on which optional inputs exist."""
    t_solve, hp = prep["t_solve"], prep["hp"]
    shape3 = (t_solve, hp, w)
    n = t_solve * hp * w
    init = (prep["init_label"].reshape(shape3)
            if prep["init_label"] is not None
            else jnp.arange(n, dtype=jnp.int32).reshape(shape3))
    constr = (prep["constraints"].reshape(shape3)
              if prep["constraints"] is not None
              else jnp.full(shape3, -1, jnp.int32))
    froz = (prep["frozen"].reshape(shape3) if prep["frozen"] is not None
            else jnp.zeros(shape3, bool))
    tf = prep["tile_fin"]
    if tf is None:
        fin = jnp.full(shape3, ov.NUM_BUCKETS, jnp.int32)
    elif tf.dtype == jnp.bool_:
        fin = jnp.where(tf.reshape(shape3), 0, ov.NUM_BUCKETS)
    else:
        fin = tf.reshape(shape3).astype(jnp.int32)
    cells = (tuple(x.reshape(shape3) for x in prep["tile_stats"])
             if prep["tile_stats"] is not None
             else tuple(jnp.zeros(shape3, jnp.float32) for _ in range(4)))
    fl = (prep["flow"] if prep["flow"] is not None
          else jnp.zeros((max(t_solve - 1, 0), hp, w, 2), jnp.float32))
    return prep["vol"], fl, init, constr, froz, fin, cells


@functools.partial(jax.jit, static_argnames=("mode", "pad_rows"))
def _preprocess_u8(frame_u8: jnp.ndarray, mode: str, pad_rows: int):
    """One device program per ingest frame: u8 -> f32 -> presmooth -> pad."""
    img = frame_u8.astype(jnp.float32) * (1.0 / 255.0)
    img = filters.presmooth(img, mode)
    if pad_rows:
        img = jnp.pad(img, ((0, pad_rows), (0, 0), (0, 0)), mode="edge")
    return img


class DenseSegmentation:
    """Streaming over-segmentation.

    Usage:
        ds = DenseSegmentation(DenseSegmentationOptions(), width, height)
        for frame in frames:
            results += ds.process_frame(False, frame, flow)
        results += ds.process_frame(True)
    """

    def __init__(self, options: DenseSegmentationOptions, frame_width: int,
                 frame_height: int,
                 solver_params: ov.OversegParams | None = None,
                 mesh=None):
        if options.chunk_size < 3:
            raise ValueError("chunk_size needs to be at least 3 frames")
        options = dataclasses.replace(options)
        base = solver_params or ov.OversegParams()
        # Multi-chip: shard the per-chunk solve's row-band dimension over
        # the mesh "space" axis (parallel.mesh.sharded_chunk_solver) — the
        # band count then equals the space axis size and bands run vmapped
        # (all resident, one per device) instead of sequentially.
        self._mesh = mesh
        self._solver_cache = {}
        mesh_bands = 0
        if mesh is not None:
            mesh_bands = dict(zip(mesh.axis_names,
                                  mesh.devices.shape))["space"]
        # Large-resolution chunks: split the solve's pixel phases into
        # spatial row bands (bounding peak memory to one band) instead of
        # shrinking the chunk below the reference's 20-frame geometry
        # (dense_segmentation.h:64-75).  Bands must align to 8-row preseg
        # subtiles; the padded rows replicate the bottom image row.
        self._bands = 1
        self._pad_rows = 0
        t_solve_full = options.chunk_size + 1
        chunk_vox = t_solve_full * frame_width * frame_height
        forced_bands = mesh_bands or options.solver_bands
        if forced_bands > 1:
            units = -(-frame_height // 8)
            u = -(-units // forced_bands)
            self._bands = forced_bands
            self._pad_rows = forced_bands * u * 8 - frame_height
            if (base.edge_table and chunk_vox // forced_bands
                    > options.max_solve_voxels):
                raise ValueError(
                    f"{forced_bands} bands leave per-band pixel phases over "
                    f"max_solve_voxels ({chunk_vox // forced_bands} > "
                    f"{options.max_solve_voxels}); use more devices or a "
                    f"smaller chunk_size")
        elif base.edge_table and chunk_vox > options.max_solve_voxels:
            unit_vox = 8 * frame_width * t_solve_full
            u_max = max(1, options.max_solve_voxels // unit_vox)
            units = -(-frame_height // 8)
            bands = min(-(-units // u_max), 16)
            u = -(-units // bands)
            self._bands = bands
            self._pad_rows = bands * u * 8 - frame_height
            import sys
            print(f"[dense] solving {frame_width}x{frame_height} in "
                  f"{bands} row bands (+{self._pad_rows} pad rows)",
                  file=sys.stderr, flush=True)
        elif not base.edge_table:
            max_chunk = options.max_solve_voxels // max(frame_width
                                                        * frame_height,
                                                        1) - 1
            if options.chunk_size > max(3, max_chunk):
                import sys
                print(f"[dense] chunk_size {options.chunk_size} -> "
                      f"{max(3, max_chunk)} to respect max_solve_voxels "
                      f"at {frame_width}x{frame_height}", file=sys.stderr, flush=True)
                options.chunk_size = max(3, max_chunk)
        self.options = options
        self.frame_width = frame_width
        self.frame_height = frame_height
        self.overlap_frames = options.overlap_frames()
        self.constraint_frames = options.constraint_frames()
        self.min_region_size = options.min_region_size(frame_width,
                                                       frame_height)
        self._params = base._replace(
            min_region_size=self.min_region_size,
            metric=options.color_distance,
            two_stage=options.two_stage_oversegment,
            bands=self._bands,
            bands_vmap=base.bands_vmap or mesh is not None,
            force_merge_weight=0.002 if options.color_distance == "l1"
            else 0.001)
        if options.preseg_mode not in ("felz", "flood"):
            raise ValueError(f"unknown preseg_mode {options.preseg_mode!r}")
        self._preseg_mode = options.preseg_mode
        if (self._preseg_mode == "felz" and self._params.edge_table
                and self._params.table_divisor
                == ov.OversegParams().table_divisor):
            # The local pre-solve collapses pixels enough for a tighter
            # region table (everything in the table phases scales with its
            # size).  Explicit caller-set divisors are respected.
            self._params = self._params._replace(table_divisor=16)

        self._buffer: list[jnp.ndarray] = []   # smoothed (Hp,W,3) on device
        # Per-frame tile preseg results, dispatched at ingest so the kernel
        # overlaps host work instead of sitting on the chunk-solve critical
        # path (tiles never cross frames, so per-frame == per-chunk labels).
        self._preseg_buffer: list = []
        self._flow_buffer: list[np.ndarray] = []
        self._has_flow = False
        self._chunk_start = 0
        self._chunk_id = 0
        self._max_region_id = 0
        self._num_output_frames = 0
        # Previous chunk state: global-id label images for the overlap
        # frames (plane 0 = emitted/frozen, plane 1.. = constrained).
        self._overlap_gids: list[np.ndarray] = []
        # Deferred host tail (options.async_tail): one worker keeps tails
        # strictly ordered; `_planes_ready` gates the next chunk's
        # constraint build on the previous tail's overlap planes.
        self._tail_exec = None
        self._pending = None
        self._planes_ready = None
        if options.async_tail:
            from concurrent.futures import ThreadPoolExecutor
            self._tail_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dense-tail")

    # -- preprocessing ----------------------------------------------------

    def preprocess(self, frame_bgr_u8: np.ndarray) -> jnp.ndarray:
        """uint8 BGR -> smoothed float [0,1] (dense_segmentation.cpp:164-198),
        padded to the band grid when the solve is banded.

        The frame crosses to the device as uint8 (the f32 convert runs on
        device): a quarter of the bytes of an f32 upload."""
        return _preprocess_u8(jnp.asarray(frame_bgr_u8),
                              self.options.presmoothing, self._pad_rows)

    def _preseg_frame(self, img: jnp.ndarray):
        """Tile-local felz preseg of one (padded) frame: frame-local voxel
        label ids, finalize levels, and cell-positioned region stats."""
        from video_segment_tpu.ops import tile_felz
        return tile_felz.tile_felzenszwalb(
            img[None], schedule=self._params.preseg_schedule,
            rounds_per_level=self._params.preseg_rounds_per_level,
            merge_threshold=self._params.merge_threshold,
            metric=self.options.color_distance,
            fin_margin=self._params.preseg_fin_margin,
            fin_eager=self._params.preseg_fin_eager,
            fin_gated=self._params.preseg_fin_gated,
            pair_merge=self._params.preseg_pair_merge)

    # -- streaming --------------------------------------------------------

    def process_frame(self, flush: bool, frame_bgr_u8: np.ndarray | None = None,
                      flow: np.ndarray | None = None) -> list[SegFrame]:
        if frame_bgr_u8 is not None:
            self._ingest(frame_bgr_u8, flow)
        if self._chunk_ready(flush):
            return self._segment_chunk(flush)
        if flush:
            return self._drain_pending()
        return []

    def _ingest(self, frame_bgr_u8: np.ndarray,
                flow: np.ndarray | None) -> None:
        img = self.preprocess(frame_bgr_u8)
        self._buffer.append(img)
        if (self._preseg_mode == "felz"
                and (self.options.tile_presegment
                     or self._params.edge_table)):
            self._preseg_buffer.append(self._preseg_frame(img))
        # flow_buffer[i] is the backward flow of buffer frame i
        # (None only for the very first video frame).  FlowField handles
        # (core/flow.py) are kept as-is: their fields stay device-resident
        # for the chunk solve and download (half-width, batched) only for
        # the host consumers, instead of paying a full f32 round-trip.
        if flow is None or hasattr(flow, "numpy_f16"):
            self._flow_buffer.append(flow)
        else:
            self._flow_buffer.append(np.asarray(flow, np.float32))
        if flow is not None:
            self._has_flow = True

    def _chunk_ready(self, flush: bool) -> bool:
        return bool(self._buffer) and (
            flush or
            len(self._buffer) - self._chunk_start >= self.options.chunk_size)

    def _drain_pending(self) -> list[SegFrame]:
        if self._pending is None:
            return []
        prev = self._pending
        self._pending = None
        self._planes_ready = None
        return list(prev.result())

    def join(self):
        """Block until deferred tail work has settled (checkpointing and
        direct streaming-state inspection need this with async_tail)."""
        if self._pending is not None:
            self._pending.result()

    # -- chunk solve ------------------------------------------------------

    def _segment_chunk(self, flush: bool) -> list[SegFrame]:
        """One streaming chunk: build solver inputs, dispatch the device
        solve, run the host tail.  Split into _prepare_chunk /
        _dispatch_solve / _post_solve so BatchDenseSegmentation can batch
        the middle step across clips (one vmapped device program)."""
        prep = self._prepare_chunk(flush)
        res = self._dispatch_solve(prep)
        return self._post_solve(prep, res, flush)

    def _prepare_chunk(self, flush: bool) -> dict:
        t = len(self._buffer)
        h, w = self.frame_height, self.frame_width
        # Pad every solve to a canonical temporal extent by repeating the
        # last frame, so the solver compiles for two shapes per resolution
        # (full chunks, and a small shape so flush tails don't pay the full
        # chunk price on mostly-padding volumes).
        t_small = min(5, self.options.chunk_size + 1)
        t_solve = t_small if t <= t_small else self.options.chunk_size + 1
        pad = t_solve - t
        # Buffered frames are already row-padded to the band grid
        # (preprocess) — pad pixels replicate the bottom row and merge into
        # the bottom-edge regions; outputs are sliced back to true height.
        hp = h + self._pad_rows
        vol = jnp.stack(self._buffer + [self._buffer[-1]] * pad)

        flow = None
        if self._has_flow and t > 1:
            tail = self._flow_buffer[1:t]
            if any(f is None for f in tail):
                raise ValueError("flow must be passed for every frame or none")
            if any(hasattr(f, "numpy_f16") for f in tail):
                # Device-resident FlowFields: stack on device — no host
                # round-trip for the solve input.
                devs = [f.device() if hasattr(f, "numpy_f16")
                        else jnp.asarray(f) for f in tail]
                flow = jnp.stack(
                    devs + [jnp.zeros_like(devs[0])] * pad)
                if self._pad_rows:
                    flow = jnp.pad(flow, ((0, 0), (0, self._pad_rows),
                                          (0, 0), (0, 0)), mode="edge")
            else:
                zero = np.zeros_like(tail[0])
                flow = np.stack(tail + [zero] * pad)
                if self._pad_rows:
                    flow = np.pad(flow, ((0, 0), (0, self._pad_rows), (0, 0),
                                         (0, 0)), mode="edge")
                flow = jnp.asarray(flow)

        # Tile pre-segmentation: collapse similar pixels into tile-local
        # regions before the global solver (felz: the tile-local
        # Felzenszwalb pre-solve; flood: the force-level merges the
        # reference performs unconditionally, pixel_distance.h:487-491).
        import os
        import time
        timing = os.environ.get("VST_TIMING")
        t_pre0 = time.monotonic()
        tile_init = None
        tile_fin = None
        tile_stats = None
        if self.options.tile_presegment or self._params.edge_table:
            if self._preseg_mode == "felz":
                # Assemble the per-frame presegs dispatched at ingest
                # (recompute any missing, e.g. after checkpoint restore).
                while len(self._preseg_buffer) < len(self._buffer):
                    k = len(self._preseg_buffer)
                    self._preseg_buffer.append(
                        self._preseg_frame(self._buffer[k]))
                per_frame = self._preseg_buffer[:t] \
                    + [self._preseg_buffer[t - 1]] * pad
                offs = (jnp.arange(t_solve, dtype=jnp.int32)[:, None, None]
                        * (hp * w))
                tile_init = jnp.concatenate(
                    [lab for lab, _, _ in per_frame]) + offs
                tile_fin = jnp.concatenate(
                    [fin for _, fin, _ in per_frame])
                tile_stats = tuple(
                    jnp.concatenate([st[i] for _, _, st in per_frame])
                    for i in range(4))
                if timing:
                    tile_init.block_until_ready()
                if not self._params.carry_preseg_fin:
                    tile_fin = None
            else:
                from video_segment_tpu.ops import tile_preseg
                # The edge-table solver needs pixels pre-collapsed far
                # enough to fit its region table; the v1 solver only wants
                # the merges the reference force-merge shortcut performs
                # unconditionally.
                thr = (self._params.preseg_threshold
                       if self._params.edge_table
                       else self._params.force_merge_weight)
                tile_init = tile_preseg.tile_presegment(
                    vol, thr, self.options.color_distance)

        # The previous chunk's (possibly deferred) tail produces the
        # overlap constraint planes — the one true serialization point.
        if self._planes_ready is not None:
            self._planes_ready.wait()

        constraints = init_label = frozen = None
        cid_to_gid = np.zeros(0, np.int64)
        if self._overlap_gids:
            # Only the first n_constrained planes carry real data; the
            # (t,hp,w)-sized constraint / frozen / init volumes are
            # assembled ON DEVICE from those small planes (uploading full
            # f32/i32 volumes would move O(chunk) bytes per chunk).
            planes = np.stack(self._overlap_gids)  # (overlap, H, W) gids
            if self._pad_rows:
                planes = np.pad(planes, ((0, 0), (0, self._pad_rows),
                                         (0, 0)), mode="edge")
            cid_to_gid, compact = np.unique(planes, return_inverse=True)
            if len(cid_to_gid) > self._params.max_constraints:
                raise ValueError(
                    f"{len(cid_to_gid)} constraint regions exceed the solver "
                    f"cap {self._params.max_constraints}")
            compact = compact.reshape(planes.shape).astype(np.int32)
            n_constrained = 1 + self.constraint_frames
            constraints = jnp.concatenate([
                jnp.asarray(compact[:n_constrained]),
                jnp.full((t_solve - n_constrained, hp, w), -1, jnp.int32)])
            frozen = jnp.concatenate([
                jnp.ones((1, hp, w), bool),
                jnp.zeros((t_solve - 1, hp, w), bool)])
            # Pre-merge plane 0: canonical voxel per compact id — per
            # (id, band) in banded solves, since band-local seed
            # compaction requires init roots inside their own band (the
            # band groups rejoin via the frozen-group constraint merge).
            init_sm = np.empty((n_constrained, hp, w), np.int32)
            for pl_i in range(1, n_constrained):
                init_sm[pl_i] = (pl_i * hp * w
                                 + np.arange(hp * w, dtype=np.int32)
                                 .reshape(hp, w))
            key0 = compact[0].astype(np.int64)
            if self._bands > 1:
                bh = hp // self._bands
                key0 = (key0 * self._bands
                        + (np.arange(hp) // bh)[:, None])
            key0 = key0.ravel()
            uniq, first = np.unique(key0, return_index=True)
            init_sm[0] = first[np.searchsorted(uniq, key0)] \
                .reshape(hp, w).astype(np.int32)
            if tile_init is not None:
                # Free planes take tile-local pre-merges.  Constrained
                # planes (1..n_constrained-1) pre-merge within
                # (preseg region x constraint id) groups: pixels that are
                # locally similar AND share a constraint merge
                # unconditionally anyway (same-constraint merges below the
                # split threshold), and per-pixel seeding would overflow
                # the solver's region table at larger frames.  Preseg
                # regions never span bands, so these stay band-local.
                # Fetch ONLY the constrained preseg planes (not the chunk).
                tile_sm = np.asarray(tile_init[1:n_constrained])
                for pl_i in range(1, n_constrained):
                    key = (tile_sm[pl_i - 1].astype(np.int64).ravel()
                           * (len(cid_to_gid) + 1)
                           + compact[pl_i].ravel() + 1)
                    uniq, first = np.unique(key, return_index=True)
                    canon = first[np.searchsorted(uniq, key)]
                    init_sm[pl_i] = (pl_i * hp * w
                                     + canon).reshape(hp, w).astype(np.int32)
                init_label = jnp.concatenate([
                    jnp.asarray(init_sm), tile_init[n_constrained:]])
                if tile_fin is not None:
                    # Constrained planes run fully open (level NUM_BUCKETS).
                    plane = jnp.arange(t_solve)[:, None, None]
                    tile_fin = jnp.where(plane >= n_constrained, tile_fin,
                                         ov.NUM_BUCKETS)
            else:
                free = jnp.arange(n_constrained * hp * w,
                                  t_solve * hp * w, dtype=jnp.int32) \
                    .reshape(t_solve - n_constrained, hp, w)
                init_label = jnp.concatenate([jnp.asarray(init_sm), free])
        elif tile_init is not None:
            init_label = tile_init

        # Live-seed count -> quantized static table size (every table-phase
        # round costs O(table), so the table tracks the true region count;
        # 32k quantization keeps the compiled-program count per resolution
        # small).
        params = self._params
        if params.edge_table and init_label is not None:
            q = 16384
            flat = init_label.reshape(-1)
            if self._bands > 1:
                bh = hp // self._bands
                isr = (flat == jnp.arange(flat.shape[0])).reshape(
                    t_solve, self._bands, bh, w)
                n_seeds = int(jnp.max(jnp.sum(isr, axis=(0, 2, 3))))
                cap_b = ((n_seeds + 1024 + q - 1) // q) * q
                params = params._replace(
                    band_table_slots=min(cap_b, t_solve * bh * w))
            else:
                if isinstance(flat, np.ndarray):
                    n_seeds = int((flat == np.arange(len(flat))).sum())
                else:
                    n_seeds = int((flat == jnp.arange(flat.shape[0])).sum())
                slots = ((n_seeds + 1024 + q - 1) // q) * q
                params = params._replace(
                    table_slots=min(slots, t_solve * hp * w))

        head_planes = (1 + self.constraint_frames if self._overlap_gids
                       else 0)
        return dict(t=t, t_solve=t_solve, hp=hp, vol=vol, flow=flow,
                    constraints=constraints, init_label=init_label,
                    frozen=frozen, tile_fin=tile_fin, tile_stats=tile_stats,
                    params=params, head_planes=head_planes,
                    cid_to_gid=cid_to_gid, timing=timing, t_pre0=t_pre0,
                    t_solve0=time.monotonic())

    def _dispatch_solve(self, prep: dict) -> ov.OversegResult:
        if self._mesh is not None:
            return self._solve_on_mesh(prep)
        return ov.oversegment(prep["vol"], flow=prep["flow"],
                              constraints=prep["constraints"],
                              init_label=prep["init_label"],
                              frozen=prep["frozen"], fin=prep["tile_fin"],
                              params=prep["params"],
                              cell_stats=prep["tile_stats"],
                              head_planes=prep["head_planes"])

    def _post_solve(self, prep: dict, res: ov.OversegResult,
                    flush: bool) -> list[SegFrame]:
        import os
        import time
        t = prep["t"]
        h, w = self.frame_height, self.frame_width
        timing = prep["timing"]
        cid_to_gid = prep["cid_to_gid"]
        t_pre0 = prep["t_pre0"]
        t_solve0 = prep["t_solve0"]
        constraints = prep["constraints"]
        n4 = self.options.enforce_n4_connectivity
        slotvol = lut = labels = None
        if res.label16 is not None and int(np.asarray(res.nsink)) == 0:
            # Compressed label transport: uint16 slot volume + int32 LUT is
            # half the bytes of the int32 label volume to download.
            # N4 enforcement runs on device before the transfer; the tail
            # then compacts by slot rank (a bincount over the u16 volume)
            # instead of re-deriving compaction from voxel ids.
            lut = np.asarray(res.lut)
            slotvol = np.asarray(
                _finalize_labels(res.label16, h, n4))[:t]
        else:
            labels = np.asarray(_finalize_labels(res.label, h, n4))[:t]
        # Fetch the (small) slot attribute arrays NOW: they are outputs of
        # the same program as `label`, so this costs nothing extra — but a
        # later np.asarray would block behind whatever device work the
        # region thread has queued in the meantime.
        solve_diag = res.diag
        res = ov.OversegResult(label=None, constr=np.asarray(res.constr),
                               size=np.asarray(res.size),
                               orig=np.asarray(res.orig))
        t_solve1 = time.monotonic()
        if timing:
            import sys
            print(f"[timing] chunk {self._chunk_id} preseg "
                  f"{t_solve0 - t_pre0:.2f}s solve "
                  f"({'constrained' if constraints is not None else 'free'})"
                  f" {t_solve1 - t_solve0:.2f}s", file=sys.stderr, flush=True)
        if solve_diag is not None:
            import sys
            dg = np.asarray(solve_diag)
            rows = " ".join(f"L{i}:cap={c} r={r} act={a}"
                            for i, (c, r, a) in enumerate(dg))
            print(f"[solve-diag] chunk {self._chunk_id} {rows}",
                  file=sys.stderr, flush=True)
        if os.environ.get("VST_VERBOSE"):
            # Merge statistics in the spirit of the reference's per-run
            # summary (segmentation_graph.h:452-462): region count, share
            # below min size, share carrying constraints.
            import sys
            sz = np.asarray(res.size)
            live = sz[sz > 0]
            n_small = int((live < self.min_region_size).sum())
            n_con = int((np.asarray(res.constr)[sz > 0] >= 0).sum())
            print(f"[stats] chunk {self._chunk_id}: regions={len(live)} "
                  f"small={n_small} constrained={n_con} "
                  f"min_region_size={self.min_region_size}",
                  file=sys.stderr, flush=True)

        # ---- host tail (deferrable) -------------------------------------
        last_output = (t - 1) if flush else (t - self.overlap_frames)
        flow_np = None
        if (self.options.enforce_spatial_connectedness and self._has_flow
                and t > 1):
            # Centroid advection samples a handful of points per frame:
            # the half-width (f16, batched) download is far inside its
            # tolerance (4% of the frame diagonal).
            flow_np = np.stack([
                f.numpy_f16() if hasattr(f, "numpy_f16") else np.asarray(f)
                for f in self._flow_buffer[1:t]])
        ctx = dict(labels=labels, slotvol=slotvol, lut=lut, res=res,
                   cid_to_gid=cid_to_gid,
                   flush=flush, t=t, last_output=last_output,
                   had_constraints=bool(self._overlap_gids),
                   chunk_start=self._chunk_start, chunk_id=self._chunk_id,
                   flow_np=flow_np, t_fetch_done=t_solve1, timing=timing)

        # Rotate streaming state now — the tail never touches it, so new
        # frames can buffer (and preseg) while the tail runs.
        if flush:
            self._buffer.clear()
            self._preseg_buffer.clear()
            self._flow_buffer.clear()
            self._chunk_start = 0
        else:
            self._buffer = self._buffer[last_output:]
            self._preseg_buffer = self._preseg_buffer[last_output:]
            self._flow_buffer = self._flow_buffer[last_output:]
            self._chunk_start = 1
        self._chunk_id += 1

        if self._tail_exec is None:
            return self._chunk_tail(ctx, None)
        import threading
        prev = self._pending
        ev = threading.Event()
        self._planes_ready = ev
        self._pending = self._tail_exec.submit(self._chunk_tail, ctx, ev)
        out = list(prev.result()) if prev is not None else []
        if flush:
            out += self._pending.result()
            self._pending = None
            self._planes_ready = None
        return out

    def _solve_on_mesh(self, prep: dict):
        """Dispatch the chunk solve through the mesh-sharded banded solver
        (parallel.mesh.sharded_chunk_solver): rows sharded over "space",
        all optional inputs materialized to their neutral volumes so the
        compiled program set stays small."""
        from video_segment_tpu.parallel import mesh as pmesh

        params = prep["params"]
        has_flow = prep["flow"] is not None
        has_constraints = prep["constraints"] is not None
        use_cells = prep["tile_stats"] is not None
        head_planes = prep["head_planes"]
        vol, fl, init_label, constr, froz, fin, cells = \
            _materialize_solve_inputs(prep, self.frame_width)
        key = (params, has_flow, has_constraints, head_planes, use_cells)
        solver = self._solver_cache.get(key)
        if solver is None:
            solver = pmesh.sharded_chunk_solver(
                self._mesh, params, has_flow, has_constraints, head_planes,
                use_cells)
            self._solver_cache[key] = solver
        return solver(vol, fl, init_label, constr, froz, fin, cells)

    def _chunk_tail(self, ctx, planes_ready) -> list[SegFrame]:
        """Post-solve host tail: n4 enforcement, label compaction, spatial
        connectedness, global id assignment, overlap constraint planes
        (signalled via `planes_ready` the moment they are set — the next
        solve's only dependency), then hierarchy extraction and per-frame
        RLE emission.  Runs on the tail worker under options.async_tail;
        strictly ordered per chunk."""
        import time
        labels = ctx["labels"]
        res = ctx["res"]
        cid_to_gid = ctx["cid_to_gid"]
        flush = ctx["flush"]
        t = ctx["t"]
        last_output = ctx["last_output"]
        chunk_start = ctx["chunk_start"]
        timing = ctx["timing"]
        h, w = self.frame_height, self.frame_width

        try:
            marks = [("start", time.monotonic())]
            # N4 enforcement already ran on device (_finalize_labels).
            marks.append(("n4", time.monotonic()))

            if ctx["slotvol"] is not None:
                # Slot-rank compaction: the solver's u16 slot volume is
                # already near-compact, so a bincount + rank gather
                # replaces the voxel-id presence scan (~4x cheaper on the
                # critical path), and slot attributes index directly.
                slotvol = ctx["slotvol"]
                lut = ctx["lut"]
                cnt = np.bincount(slotvol.ravel(), minlength=len(lut))
                present = cnt > 0
                rank = (np.cumsum(present) - 1).astype(np.int32)
                compact = rank[slotvol]
                num_regions = int(present.sum())
                constr_of_region = np.asarray(res.constr)[present]
            else:
                compact, roots = rle.compact_labels(labels)
                num_regions = len(roots)
                constr_of_region, _ = ov.region_attrs(res, roots)
            marks.append(("compact", time.monotonic()))

            if self.options.enforce_spatial_connectedness:
                from video_segment_tpu.core import connectedness
                compact, n2, _origin = \
                    connectedness.enforce_spatial_connectedness(
                        compact, num_regions, flow=ctx["flow_np"])
                if n2 > num_regions:
                    # Split-off tubes are new, unconstrained regions
                    # (dense_segmentation_graph.h:867-904 relabels them).
                    constr_of_region = np.concatenate(
                        [constr_of_region,
                         np.full(n2 - num_regions, -1,
                                 constr_of_region.dtype)])
                    num_regions = n2
            marks.append(("connect", time.monotonic()))

            # Global id assignment (AssignUniqueRegionIds).
            gids = np.full(num_regions, -1, np.int64)
            constrained = constr_of_region >= 0
            if constrained.any():
                gids[constrained] = cid_to_gid[constr_of_region[constrained]]
            new_idx = np.flatnonzero(~constrained)
            gids[new_idx] = self._max_region_id + np.arange(len(new_idx))
            self._max_region_id = max(self._max_region_id,
                                      int(gids.max()) + 1)
            gid_map = gids  # compact region -> global id

            # Overlap constraint planes: release the next solve.
            if flush:
                self._overlap_gids = []
            else:
                self._overlap_gids = [gid_map[compact[f]]
                                      for f in range(last_output, t)]
        finally:
            if planes_ready is not None:
                planes_ready.set()

        # Output geometry.
        window_lo = 1 if ctx["had_constraints"] else 0  # excl. frozen plane
        out_chunk_size = last_output - chunk_start + 1
        hierarchy_frame_idx = self._num_output_frames
        global_frame0 = self._num_output_frames - chunk_start

        marks.append(("gids", time.monotonic()))
        # Level-0 hierarchy over the window [window_lo, last_output].
        win = compact[window_lo:last_output + 1]
        start_f, end_f, _ = rle.region_presence(win, num_regions)
        sizes = rle.region_sizes(win, num_regions)
        in_window = sizes > 0
        pairs = rle.neighbor_pairs(win)
        keep = in_window[pairs[:, 0]] & in_window[pairs[:, 1]]
        gp = gids[pairs[keep]]
        gp = np.sort(gp, axis=1)
        order = np.argsort(gids[in_window], kind="stable")
        hier = HierarchyLevelData(
            ids=gids[in_window][order],
            sizes=sizes[in_window][order],
            start_frames=global_frame0 + window_lo + start_f[in_window][order],
            end_frames=global_frame0 + window_lo + end_f[in_window][order],
            neighbor_pairs=gp)
        marks.append(("hier", time.monotonic()))

        # Emit frames [chunk_start, last_output].
        results = []
        for local in range(chunk_start, last_output + 1):
            gimg = gid_map[compact[local]]
            ids, counts, ys, lxs, rxs = rle.frame_rle(gimg)
            results.append(SegFrame(
                frame_width=w, frame_height=h,
                region_ids=ids, interval_counts=counts,
                ys=ys, lxs=lxs, rxs=rxs,
                moments=rle.shape_moments(counts, ys, lxs, rxs),
                chunk_size=out_chunk_size, overlap_start=out_chunk_size,
                chunk_id=ctx["chunk_id"],
                hierarchy_frame_idx=hierarchy_frame_idx,
                hierarchy=[hier] if local == chunk_start else None,
                frame_index=global_frame0 + local))
        self._num_output_frames += len(results)
        if timing:
            import sys
            marks.append(("rle", time.monotonic()))
            steps = " ".join(f"{name} {tb - ta:.2f}" for (_, ta), (name, tb)
                             in zip(marks, marks[1:]))
            print(f"[timing] chunk {ctx['chunk_id']} dense-host-tail "
                  f"{time.monotonic() - ctx['t_fetch_done']:.2f}s ({steps})",
                  file=sys.stderr, flush=True)
        return results
