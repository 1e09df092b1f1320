"""SegFrame -> serialized SegmentationDesc bytes.

Bridges the core drivers' numpy result records to the wire format through
the vectorized encoder (dataio.fast_proto); the protobuf runtime is needed
only for vectorized output, which edits a parsed message.
"""

from __future__ import annotations

import numpy as np

from video_segment_tpu.dataio import fast_proto

N4_CONNECT = 1   # SegmentationDesc.Connectedness


def _lists(ids: np.ndarray, owner: np.ndarray, member: np.ndarray):
    """Per-region sorted member lists as (counts, flat members) aligned
    with ascending `ids`; entries whose owner is not in `ids` drop."""
    order = np.lexsort((member, owner))
    owner, member = owner[order], member[order]
    pos = np.searchsorted(ids, owner)
    ok = (pos < len(ids)) & (ids[np.minimum(pos, len(ids) - 1)] == owner)
    return (np.bincount(pos[ok], minlength=len(ids)),
            member[ok])


def hierarchy_level_bytes(lvl) -> bytes:
    """HierarchyLevelData -> serialized HierarchyLevel body.  Neighbor
    lists come from the symmetric closure of the (a,b) pairs, child lists
    from the (parent, child) pairs; both sorted."""
    ids = np.asarray(lvl.ids, np.int64)
    pairs = np.asarray(lvl.neighbor_pairs, np.int64).reshape(-1, 2)
    n_counts, n_ids = _lists(ids, np.concatenate([pairs[:, 0], pairs[:, 1]]),
                             np.concatenate([pairs[:, 1], pairs[:, 0]]))
    c_counts = c_ids = None
    if lvl.child_pairs is not None and len(lvl.child_pairs):
        cp = np.asarray(lvl.child_pairs, np.int64)
        c_counts, c_ids = _lists(ids, cp[:, 0], cp[:, 1])
    return fast_proto.encode_hierarchy_level(
        ids, lvl.sizes, lvl.start_frames, lvl.end_frames, n_counts, n_ids,
        parent_ids=lvl.parent_ids, child_counts=c_counts, child_ids=c_ids)


def hierarchy_to_proto(levels) -> list:
    """list[HierarchyLevelData] -> list[proto HierarchyLevel]."""
    from video_segment_tpu import proto
    return [proto.HierarchyLevel.FromString(hierarchy_level_bytes(lvl))
            for lvl in levels]


def _region_features_bytes(region_ids: np.ndarray) -> bytes:
    """Serialized `repeated RegionFeatures features = 10` entries, one per
    region with only the required `fixed32 id = 1` set — exactly what the
    reference emits under save_descriptors (segmentation.cpp:491-501; every
    AddToRegionFeatures implementation is empty, region_descriptor.cpp:137,
    :333).  Appended raw: protobuf fields parse in any byte order."""
    out = bytearray()
    for rid in np.asarray(region_ids).tolist():
        body = b"\x0d" + int(rid).to_bytes(4, "little")   # field 1, fixed32
        out += b"\x52" + fast_proto.encode_varint(len(body)) + body
    return bytes(out)


def segframe_to_bytes(sf, vectorize: bool = False,
                      remove_rasterization: bool = False,
                      output_dims: tuple | None = None,
                      save_descriptors: bool = False) -> bytes:
    """Serialize a core.dense.SegFrame to SegmentationDesc wire bytes.

    With `vectorize`, region boundary polygons are computed and attached
    (and rasterizations optionally stripped, the reference's
    --write_to_file output shape, seg_tree.cpp:302-312).  `output_dims`
    (width, height) upscales the vector mesh and the emitted frame
    dimensions when segmentation ran on a downscaled video — requires
    remove_rasterization (the reference writer unit's upscale path,
    segmentation_unit.cpp:373-411)."""
    hierarchy = ([hierarchy_level_bytes(lvl) for lvl in sf.hierarchy]
                 if sf.hierarchy else None)
    payload = fast_proto.encode_frame(
        sf.region_ids, sf.interval_counts, sf.ys, sf.lxs, sf.rxs,
        getattr(sf, "moments", None),
        frame_width=sf.frame_width, frame_height=sf.frame_height,
        chunk_size=sf.chunk_size, overlap_start=sf.overlap_start,
        chunk_id=sf.chunk_id, hierarchy_frame_idx=sf.hierarchy_frame_idx,
        connectedness=N4_CONNECT, hierarchy=hierarchy)
    if save_descriptors and hierarchy is not None:
        # The reference gates on output_hierarchy (segmentation.cpp:491):
        # features ride only on hierarchy (chunk-start) frames.
        payload += _region_features_bytes(sf.region_ids)
    if not vectorize:
        return payload

    from video_segment_tpu import proto
    from video_segment_tpu.segment_util import boundary, util
    intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
    lab = util.rasterize_ids(sf.region_ids.astype(np.int64),
                             sf.interval_counts, intervals,
                             sf.frame_height, sf.frame_width)
    from video_segment_tpu.segment_util import joint_boundary
    mesh, polys = joint_boundary.compute_vectorization(lab)
    desc = proto.SegmentationDesc()
    desc.ParseFromString(payload)
    if output_dims and (output_dims != (sf.frame_width, sf.frame_height)):
        if not remove_rasterization:
            raise ValueError("upscaled output requires remove_rasterization")
        ow, oh = output_dims
        boundary.vectorization_to_proto(desc, mesh, polys, True)
        boundary.scale_vectorization(desc, ow / sf.frame_width,
                                     oh / sf.frame_height)
        desc.frame_width = ow
        desc.frame_height = oh
    else:
        boundary.vectorization_to_proto(desc, mesh, polys,
                                        remove_rasterization)
    return desc.SerializeToString()
