"""Host-side codecs that replace optional packages on the segmentation
path, checked against those packages where they are installed."""

import numpy as np
import pytest

from video_segment_tpu.core.dense import HierarchyLevelData
from video_segment_tpu.core.region import bgr_to_lab
from video_segment_tpu.dataio import emit, fast_proto


def test_bgr_to_lab_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    v = np.arange(0, 256, 3, dtype=np.uint8)
    cube = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 1, 3)
    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
    for x in (cube, img):
        diff = np.abs(bgr_to_lab(x).astype(int)
                      - cv2.cvtColor(x, cv2.COLOR_BGR2Lab).astype(int))
        assert diff.max() <= 1


def _level(rng, parents):
    ids = np.sort(rng.choice(1000, 40, replace=False))
    pairs = np.sort(rng.choice(ids, (90, 2)), axis=1)
    pairs = np.unique(pairs[pairs[:, 0] < pairs[:, 1]], axis=0)
    start = rng.integers(0, 30, len(ids))
    return HierarchyLevelData(
        ids=ids, sizes=rng.integers(1, 10 ** 6, len(ids)),
        start_frames=start, end_frames=start + rng.integers(0, 9, len(ids)),
        neighbor_pairs=pairs,
        parent_ids=(rng.integers(0, 5, len(ids)) if parents else None),
        child_pairs=(np.stack([rng.choice(ids, 60), rng.integers(0, 99, 60)],
                              1) if parents else None))


@pytest.mark.parametrize("parents", [True, False])
def test_hierarchy_bytes_match_protobuf(parents):
    """fast_proto's HierarchyLevel bytes equal what the protobuf classes
    serialize for the same level (sorted neighbor and child lists)."""
    pytest.importorskip("google.protobuf")
    from video_segment_tpu import proto

    lvl = _level(np.random.default_rng(int(parents)), parents)
    msg = proto.HierarchyLevel()
    for i, rid in enumerate(lvl.ids.tolist()):
        cr = msg.region.add()
        cr.id = rid
        cr.size = int(lvl.sizes[i])
        nb = sorted({int(b) for a, b in lvl.neighbor_pairs if a == rid}
                    | {int(a) for a, b in lvl.neighbor_pairs if b == rid})
        cr.neighbor_id.extend(nb)
        if parents:
            cr.parent_id = int(lvl.parent_ids[i])
            cr.child_id.extend(sorted(int(c) for p, c in lvl.child_pairs
                                      if p == rid))
        cr.start_frame = int(lvl.start_frames[i])
        cr.end_frame = int(lvl.end_frames[i])
    got = emit.hierarchy_level_bytes(lvl)
    assert proto.HierarchyLevel.FromString(got) == msg
    assert got == msg.SerializeToString()
    # The protobuf-free decoder reads the same level back.
    frame = fast_proto.encode_frame(
        np.array([1]), np.array([1]), np.array([0]), np.array([0]),
        np.array([3]), frame_width=4, frame_height=1, chunk_id=-1,
        hierarchy=[got])
    dec = fast_proto.decode_frame(frame)
    assert dec["chunk_id"] == -1
    assert dec["hierarchy"][0]["ids"] == lvl.ids.tolist()
    assert dec["hierarchy"][0]["neighbors"] == [list(r.neighbor_id)
                                                for r in msg.region]
