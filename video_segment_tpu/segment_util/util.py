"""Host utilities over segmentation results (parsed protobufs).

Re-implements the consumer-side helpers of the reference's
segment_util/segmentation_util.{h,cpp}: hierarchy accessors and parent
resolution, id-image rendering at any hierarchy level, global hierarchy
construction across chunks, and validation.
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu.dataio import fast_proto


def absolute_level(hierarchy, fractional_level: float) -> int:
    """Fractional [0,1) -> absolute level index (renderer/converter rule:
    level = frac * hierarchy_size, segment_renderer/renderer.cpp:261-267)."""
    if fractional_level <= 0 or not hierarchy:
        return 0
    if fractional_level < 1:
        return min(int(fractional_level * len(hierarchy)), len(hierarchy) - 1)
    return min(int(fractional_level), len(hierarchy) - 1)


def parent_map(hierarchy, level: int) -> dict[int, int]:
    """Map over-segmentation (level-0) region id -> ancestor id at `level`
    (GetParentId semantics, segmentation_util.cpp:166-199)."""
    mapping = {int(r.id): int(r.id) for r in hierarchy[0].region}
    for l in range(level):
        step = {int(r.id): int(r.parent_id) for r in hierarchy[l].region}
        mapping = {leaf: step.get(cur, cur) for leaf, cur in mapping.items()}
    return mapping


def get_parent_id(region_id: int, level: int, query_level: int,
                  hierarchy) -> int:
    """Ancestor of `region_id` (at `level`) at `query_level`."""
    cur = region_id
    for l in range(level, query_level):
        by_id = {int(r.id): r for r in hierarchy[l].region}
        cur = int(by_id[cur].parent_id)
    return cur


def desc_to_id_image(desc, hierarchy=None, level: int = 0) -> np.ndarray:
    """Render a SegmentationDesc frame to an int64 id image at `level`
    (SegmentationDescToIdImage, segmentation_util.cpp:741-770).  Streams
    with stripped rasterizations are rebuilt from their vectorization."""
    h, w = desc.frame_height, desc.frame_width
    if desc.rasterization_removed:
        replace_rasterization_from_vectorization(desc)
    ids, counts, intervals = fast_proto.decode_rasterizations(desc)
    if level > 0:
        pm = parent_map(hierarchy, level)
        draw = np.array([pm[int(i)] for i in ids], np.int64)
    else:
        draw = ids.astype(np.int64)
    return rasterize_ids(draw, counts, intervals, h, w)


def rasterize_ids(draw_ids, counts, intervals, h, w) -> np.ndarray:
    """Vectorized scanline fill: per-region draw ids over RLE intervals."""
    img = np.full(h * w, -1, np.int64)
    if len(intervals) == 0:
        return img.reshape(h, w)
    ys = intervals[:, 0].astype(np.int64)
    lxs = intervals[:, 1].astype(np.int64)
    rxs = intervals[:, 2].astype(np.int64)
    lens = rxs - lxs + 1
    starts = ys * w + lxs
    total = int(lens.sum())
    offs = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(lens)[:-1])), lens)
    pos = np.repeat(starts, lens) + offs
    vals = np.repeat(np.repeat(draw_ids, counts), lens)
    img[pos] = vals
    return img.reshape(h, w)


def replace_rasterization_from_vectorization(desc) -> None:
    """Rebuild per-region RLE rasters from polygon vectorizations in place
    (ReplaceRasterizationFromVectorization, segmentation_util.cpp:1238) —
    used by consumers of rasterization-stripped streams.

    Polygons are in corner space [0,W]x[0,H] (boundary.h:41-43) and come
    from jointly traced shared segments, so even-odd rasterization
    partitions the frame exactly — no crack-filling pass is needed."""
    from video_segment_tpu.segment_util import joint_boundary

    coords = np.asarray(desc.vector_mesh.coord, np.float32)
    h, w = desc.frame_height, desc.frame_width
    poly_sets = []
    for r in desc.region:
        rings = []
        for poly in r.vectorization.polygon:
            idx = np.asarray(poly.coord_idx, np.int64)
            rings.append(np.stack([coords[idx], coords[idx + 1]], axis=1))
        poly_sets.append((r.id, rings))
    lab = joint_boundary.rasterize_polygons(h, w, poly_sets)

    for r in desc.region:
        r.ClearField("raster")
        ys, xs = np.nonzero(lab == r.id)
        if len(ys) == 0:
            r.raster.SetInParent()
            continue
        start = np.ones(len(ys), bool)
        start[1:] = (ys[1:] != ys[:-1]) | (xs[1:] != xs[:-1] + 1)
        s_idx = np.flatnonzero(start)
        e_idx = np.append(s_idx[1:], len(ys)) - 1
        for s, e in zip(s_idx, e_idx):
            si = r.raster.scan_inter.add()
            si.y = int(ys[s])
            si.left_x = int(xs[s])
            si.right_x = int(xs[e])
    desc.rasterization_removed = False


def build_global_hierarchy(chunk_hierarchies: list) -> list:
    """Merge per-chunk hierarchies into one video-global hierarchy
    (BuildGlobalHierarchy, segmentation_util.cpp:877-923).

    Compound regions with the same id across chunks are merged: sizes added,
    neighbor/child id lists unioned, frame spans extended; hierarchy depth is
    truncated to the minimum across chunks (TruncateHierarchy)."""
    if not chunk_hierarchies:
        return []
    from video_segment_tpu import proto
    depth = min(len(h) for h in chunk_hierarchies)
    out = []
    for level in range(depth):
        merged: dict[int, dict] = {}
        for h in chunk_hierarchies:
            for r in h[level].region:
                e = merged.get(r.id)
                if e is None:
                    merged[r.id] = {
                        "size": r.size,
                        "neighbors": set(r.neighbor_id),
                        "parent": r.parent_id,
                        "children": set(r.child_id),
                        "start": r.start_frame,
                        "end": r.end_frame,
                    }
                else:
                    e["size"] += r.size
                    e["neighbors"].update(r.neighbor_id)
                    e["children"].update(r.child_id)
                    e["start"] = min(e["start"], r.start_frame)
                    e["end"] = max(e["end"], r.end_frame)
        lvl = proto.HierarchyLevel()
        for rid in sorted(merged):
            e = merged[rid]
            cr = lvl.region.add()
            cr.id = rid
            cr.size = e["size"]
            cr.neighbor_id.extend(sorted(e["neighbors"]))
            if level + 1 < depth:
                cr.parent_id = e["parent"]
            cr.child_id.extend(sorted(e["children"]))
            cr.start_frame = e["start"]
            cr.end_frame = e["end"]
        out.append(lvl)
    return out


def verify_global_hierarchy(hierarchy) -> list[str]:
    """Consistency checks (VerifyGlobalHierarchy,
    segmentation_util.cpp:925-1007). Returns a list of violation messages."""
    errors = []
    for level, lvl in enumerate(hierarchy):
        by_id = {int(r.id): r for r in lvl.region}
        for r in lvl.region:
            for n in r.neighbor_id:
                other = by_id.get(n)
                if other is None:
                    errors.append(f"L{level} R{r.id}: neighbor {n} missing")
                elif r.id not in other.neighbor_id:
                    errors.append(f"L{level} R{r.id}: neighbor {n} asymmetric")
        if level + 1 < len(hierarchy):
            parents = {int(r.id): r for r in hierarchy[level + 1].region}
            for r in lvl.region:
                p = parents.get(int(r.parent_id))
                if p is None:
                    errors.append(f"L{level} R{r.id}: parent {r.parent_id} "
                                  "missing")
                elif r.id not in p.child_id:
                    errors.append(f"L{level} R{r.id}: not in parent "
                                  f"{r.parent_id} child list")
    return errors
