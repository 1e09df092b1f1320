"""Fused multi-clip dense over-segmentation driver.

BASELINE config 5's device-side batch design: N same-resolution clips
stream in lockstep, and each chunk index solves as ONE vmapped device
program over the clip axis instead of N serialized per-clip programs —
the fused form of what tools/batch_segment --concurrent approximates by
interleaving.  Host tails (device-N4 slot compaction, spatial
connectedness, global ids, RLE, hierarchy) stay per-clip and overlap the
next batched solve through each clip's async tail worker.  Reference
workload shape: one seg_tree pipeline per clip
(/root/reference/seg_tree_sample/seg_tree.cpp:85-369).

Batching discipline (advisor round-3 items):
- The clip axis is part of the compiled shape; a driver should feed a
  fixed clip count per batch.  Clips whose streams diverge (different
  buffered lengths, constrained vs free chunks) fall back to per-clip
  dispatch for that step — correctness is unconditional, fusion is the
  fast path.
- The batched program's live solve footprint is clips * T * H * W voxels;
  the constructor rejects configurations whose batch exceeds
  `max_solve_voxels` (DenseSegmentationOptions).  High
  resolutions (720p+) use banded solves and must batch via
  --concurrent interleaving or the mesh "data" axis instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.core import oversegmentation as ov
from video_segment_tpu.core.dense import (DenseSegmentation, SegFrame,
                                          _materialize_solve_inputs)
from video_segment_tpu.core.options import DenseSegmentationOptions


class BatchDenseSegmentation:
    """Lockstep multi-clip streaming over-segmentation.

    Usage:
        bd = BatchDenseSegmentation(options, w, h, n_clips)
        for step in range(n_frames):
            outs = bd.process_frames(False, [clip_frame(i) for i in range(n)])
        outs = bd.process_frames(True)
    `outs[i]` is clip i's list of SegFrame results, same contract as
    DenseSegmentation.process_frame.
    """

    def __init__(self, options: DenseSegmentationOptions, frame_width: int,
                 frame_height: int, n_clips: int,
                 solver_params: ov.OversegParams | None = None):
        if n_clips < 1:
            raise ValueError("n_clips must be >= 1")
        # The batched program's live pixel-phase footprint is
        # n_clips x (one band).  Scaling the per-clip voxel budget down by
        # the clip count makes each clip pick a band decomposition whose
        # vmapped batch fits the ORIGINAL budget — that is how 720p/1080p
        # clips share one fused banded program (the round-4 driver refused
        # banded shapes outright and fell back to interleaving).
        import dataclasses as _dc
        opts = _dc.replace(
            options,
            max_solve_voxels=max(options.max_solve_voxels // n_clips, 1))
        self.clips = [DenseSegmentation(opts, frame_width, frame_height,
                                        solver_params=solver_params)
                      for _ in range(n_clips)]
        c0 = self.clips[0]
        vox = (n_clips * (c0.options.chunk_size + 1)
               * ((frame_height + c0._pad_rows) // max(c0._bands, 1))
               * frame_width)
        assert vox <= options.max_solve_voxels * 2, (
            f"batched per-band footprint {vox} exceeds budget "
            f"{options.max_solve_voxels}")
        self._vm_cache: dict = {}

    # -- streaming --------------------------------------------------------

    def process_frames(self, flush: bool,
                       frames: list[np.ndarray | None] | None = None,
                       flows: list[np.ndarray | None] | None = None
                       ) -> list[list[SegFrame]]:
        if frames is not None:
            if flows is None:
                flows = [None] * len(self.clips)
            for ds, fr, fl in zip(self.clips, frames, flows):
                if fr is not None:
                    ds._ingest(fr, fl)

        outs: list[list[SegFrame]] = [[] for _ in self.clips]
        ready = [i for i, ds in enumerate(self.clips)
                 if ds._chunk_ready(flush)]
        if ready:
            preps = [self.clips[i]._prepare_chunk(flush) for i in ready]
            results = self._solve_batch([self.clips[i] for i in ready],
                                        preps)
            for i, prep, res in zip(ready, preps, results):
                outs[i] = self.clips[i]._post_solve(prep, res, flush)
        if flush:
            for i, ds in enumerate(self.clips):
                if i not in ready:
                    outs[i] = ds._drain_pending()
        return outs

    def join(self):
        for ds in self.clips:
            ds.join()

    # -- batched dispatch -------------------------------------------------

    @staticmethod
    def _signature(prep: dict):
        """Chunk class: preps in the same class share one vmapped program
        (their params may differ only in live-seed table sizing, unified
        to the max across the batch)."""
        return (prep["t_solve"], prep["hp"],
                prep["flow"] is not None,
                prep["constraints"] is not None,
                prep["tile_stats"] is not None,
                prep["head_planes"],
                prep["params"]._replace(table_slots=0))

    def _solve_batch(self, clips, preps) -> list[ov.OversegResult]:
        groups: dict = {}
        for k, prep in enumerate(preps):
            groups.setdefault(self._signature(prep), []).append(k)
        results: list = [None] * len(preps)
        for sig, members in groups.items():
            if len(members) == 1:
                k = members[0]
                results[k] = clips[k]._dispatch_solve(preps[k])
                continue
            (t_solve, hp, has_flow, has_constraints, use_cells,
             head_planes, params0) = sig
            params = params0._replace(table_slots=max(
                preps[k]["params"].table_slots for k in members))
            w = clips[members[0]].frame_width
            stacked = [_materialize_solve_inputs(preps[k], w)
                       for k in members]
            args = jax.tree.map(lambda *xs: jnp.stack(xs), *stacked)
            fn = self._vmapped(params, has_flow, has_constraints,
                               use_cells, head_planes)
            out = fn(*args)
            for j, k in enumerate(members):
                results[k] = jax.tree.map(lambda x, j=j: x[j], out)
        return results

    def _vmapped(self, params, has_flow: bool, has_constraints: bool,
                 use_cells: bool, head_planes: int):
        key = (params, has_flow, has_constraints, use_cells, head_planes)
        fn = self._vm_cache.get(key)
        if fn is not None:
            return fn

        def one(vol, fl, init, constr, froz, fin, cells):
            t, h, w, _ = vol.shape
            n = t * h * w
            return ov._solve(
                vol, fl, init.reshape(n), constr.reshape(n),
                froz.reshape(n), fin.reshape(n), params, has_flow,
                has_constraints,
                tuple(c.reshape(n) for c in cells) if use_cells else None,
                head_planes)

        fn = jax.jit(jax.vmap(one))
        self._vm_cache[key] = fn
        return fn
