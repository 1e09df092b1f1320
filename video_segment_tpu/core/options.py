"""Configuration dataclasses mirroring the reference's option structs.

Knob names and defaults follow the reference so users can carry settings
over directly (DenseSegmentationOptions: dense_segmentation.h:42-95;
RegionSegmentationOptions: region_segmentation.h:41-82; SegmentationOptions:
segmentation.h:46-95).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DenseSegmentationOptions:
    presmoothing: str = "bilateral"          # none | gaussian | bilateral
    frac_min_region_size: float = 0.01
    chunk_size: int = 20
    chunk_overlap_ratio: float = 0.2
    two_stage_oversegment: bool = False
    num_constraint_frames: int = 1
    enforce_n4_connectivity: bool = True
    enforce_spatial_connectedness: bool = True
    color_distance: str = "l2"               # l1 | l2
    compute_vectorization: bool = False
    # Tile pre-segmentation before the solver.  The edge-table solver
    # REQUIRES it (its region table is sized well below the pixel count);
    # dense.py forces it on when OversegParams.edge_table is set.
    tile_presegment: bool = True
    # Preseg flavor: "felz" = full tile-local Felzenszwalb (ops/tile_felz,
    # the path the quality defaults were tuned on), "flood" = force-level
    # tile flooding (ops/tile_preseg).
    preseg_mode: str = "felz"
    # Upper bound on voxels per solve's pixel phases: above it, the
    # edge-table solve splits into row bands (the v1 solver shrinks the
    # chunk instead).  A default carried over from the first target
    # device, to be re-derived from the GPU's memory (ROADMAP S5).
    max_solve_voxels: int = 8_000_000
    # Explicit solver row-band count (0 = derive from max_solve_voxels).
    # Used to pin a band decomposition, e.g. to compare a mesh-sharded run
    # (bands == mesh "space" size) against a single-device control.
    solver_bands: int = 0
    # Run the host post-solve tail (n4/connectedness/RLE/id assignment) on
    # a worker thread so the device starts the next chunk's preseg/solve
    # as soon as the tail has produced the overlap constraint planes.
    # Results then arrive one chunk later (all frames still emitted, in
    # order, by the flush call) — callers that rely on per-call emission
    # timing keep the default synchronous tail.
    async_tail: bool = False

    def overlap_frames(self) -> int:
        # The reference clamps to at most 2 and requires at least 2 to seed
        # the next chunk (dense_segmentation.cpp:59-62, CHECK at :367);
        # i.e. it only ever operates with exactly 2 overlap frames.
        return 2

    def constraint_frames(self) -> int:
        return min(self.num_constraint_frames, self.overlap_frames() - 1)

    def min_region_size(self, width: int, height: int) -> int:
        return max(1, int(self.frac_min_region_size * width *
                          self.frac_min_region_size * height *
                          self.chunk_size))


@dataclasses.dataclass
class RegionSegmentationOptions:
    min_region_num: int = 10
    max_region_num: int = 10000
    level_cutoff_fraction: float = 0.8
    small_region_penalizer: float = 0.25
    luminance_bins: int = 10
    color_bins: int = 20
    flow_bins: int = 16
    chunk_set_size: int = 6
    chunk_set_overlap: int = 2
    constraint_chunks: int = 1
    use_appearance: bool = True
    use_flow: bool = True
    use_size_penalizer: bool = True
    compute_vectorization: bool = True
    # Gain-calibrated windowed appearance histograms
    # (WindowedAppearanceDescriptor, region_descriptor.h:262-316): one
    # histogram per `appearance_window_size`-frame window, pixels rescaled
    # by anchor/frame Lab mean gain; distances search windows +/-1.
    # 0 = single histogram per region (the reference's own default).
    # Memory scales with windows x regions x bins — intended for coarse
    # windows (>= chunk_size / 2).
    appearance_window_size: int = 0
    # Agglomeration order fidelity: phases whose region table is <= this
    # cap re-aggregate statistics and re-evaluate edge distances at every
    # subround (the fine-grained approximation of the reference's
    # re-evaluation after every single merge,
    # region_segmentation_graph.cpp:409-503).  16384 covers the base level
    # (max_region_num defaults to 10000), so no level merges on frozen
    # distances; lower to 1024 to trade fidelity for agglomeration time.
    agglo_reeval_cap: int = 16384
    # Merge subrounds per hierarchy level; the level budget splits across
    # them, so more subrounds = fewer merges per distance re-evaluation.
    agglo_subrounds: int = 6
    # Emit per-region appearance/flow descriptors into the output stream
    # (RegionFeatures, segmentation.cpp:491-501; AddToRegionFeatures,
    # region_descriptor.cpp).  Off by default, as in the reference.
    save_descriptors: bool = False
