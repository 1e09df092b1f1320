"""Proto wire compatibility + chunked container round-trip tests."""

import numpy as np
import pytest

from video_segment_tpu import proto
from video_segment_tpu.dataio import fast_proto, seg_io


def _random_frame(rng, n_regions=50, max_intervals=20, h=480, w=640):
    ids = np.sort(rng.choice(10 ** 6, size=n_regions, replace=False))
    counts = rng.integers(0, max_intervals, size=n_regions)
    total = int(counts.sum())
    ys = rng.integers(0, h, size=total)
    lxs = rng.integers(0, w - 1, size=total)
    rxs = lxs + rng.integers(0, w - lxs, size=total)
    return ids, counts, ys, lxs, rxs


def test_encode_regions_matches_protobuf(rng):
    ids, counts, ys, lxs, rxs = _random_frame(rng)
    fast = fast_proto.encode_regions(ids, counts, ys, lxs, rxs)

    ref = proto.SegmentationDesc()
    pos = 0
    for i, rid in enumerate(ids):
        r = ref.region.add()
        r.id = int(rid)
        r.raster.SetInParent()
        for _ in range(counts[i]):
            si = r.raster.scan_inter.add()
            si.y = int(ys[pos])
            si.left_x = int(lxs[pos])
            si.right_x = int(rxs[pos])
            pos += 1
    assert fast == ref.SerializeToString()


def test_encode_regions_large_values():
    # Multi-byte varints everywhere (ids up to 2^30, coords beyond 2^21).
    ids = np.array([0, 127, 128, 2 ** 21, 2 ** 30], np.int64)
    counts = np.array([1, 2, 0, 1, 3], np.int64)
    ys = np.array([0, 5, 2 ** 20, 3, 16383, 16384, 99], np.int64)
    lxs = np.array([1, 2, 3, 4, 5, 6, 7], np.int64)
    rxs = np.array([1, 300, 70000, 4, 5, 2 ** 24, 7], np.int64)
    fast = fast_proto.encode_regions(ids, counts, ys, lxs, rxs)

    m = proto.SegmentationDesc()
    m.ParseFromString(fast)
    assert [r.id for r in m.region] == list(ids)
    got = [(si.y, si.left_x, si.right_x)
           for r in m.region for si in r.raster.scan_inter]
    assert got == list(zip(ys.tolist(), lxs.tolist(), rxs.tolist()))


def test_encode_frame_full_parse(rng):
    ids, counts, ys, lxs, rxs = _random_frame(rng, n_regions=10)
    level = proto.HierarchyLevel()
    cr = level.region.add()
    cr.id = 7
    cr.size = 1234
    cr.neighbor_id.extend([8, 9])
    cr.parent_id = 3
    payload = fast_proto.encode_frame(
        ids, counts, ys, lxs, rxs,
        frame_width=640, frame_height=480, chunk_size=20,
        overlap_start=18, chunk_id=2, hierarchy_frame_idx=40,
        connectedness=proto.N4_CONNECT, hierarchy=[level.SerializeToString()])
    m = proto.SegmentationDesc()
    m.ParseFromString(payload)
    assert m.frame_width == 640 and m.frame_height == 480
    assert m.chunk_size == 20 and m.overlap_start == 18
    assert m.chunk_id == 2 and m.hierarchy_frame_idx == 40
    assert len(m.region) == 10
    assert len(m.hierarchy) == 1
    assert m.hierarchy[0].region[0].neighbor_id == [8, 9]


def test_container_roundtrip(tmp_path, rng):
    path = str(tmp_path / "out.pb")
    w = seg_io.SegmentationWriter(path)
    assert w.open_file(header_flags=[1, 0])
    payloads = []
    for i in range(25):
        ids, counts, ys, lxs, rxs = _random_frame(rng, n_regions=5)
        p = fast_proto.encode_frame(ids, counts, ys, lxs, rxs,
                                    frame_width=64, frame_height=48)
        payloads.append(p)
        w.add_to_chunk(p, pts=i * 100)
        if (i + 1) % 10 == 0:
            w.write_chunk()
    w.write_term_and_close()

    r = seg_io.SegmentationReader(path)
    assert r.open_and_read_headers()
    assert r.header_flags == [1, 0]
    assert r.num_frames == 25
    assert r.frame_pts == [i * 100 for i in range(25)]
    got = list(r)
    assert got == payloads
    # Random access.
    r.seek_to_frame(13)
    assert r.read_frame() == payloads[13]
    r.close()


def test_container_binary_layout(tmp_path):
    """Spot-check the raw byte layout against the documented format."""
    path = str(tmp_path / "layout.pb")
    w = seg_io.SegmentationWriter(path)
    w.open_file()
    w.add_to_chunk(b"abc", pts=42)
    w.write_chunk()
    w.write_term_and_close()
    raw = open(path, "rb").read()
    assert raw[:4] == b"HEAD"
    assert int.from_bytes(raw[4:8], "little") == 0
    assert raw[8:12] == b"CHNK"
    assert int.from_bytes(raw[12:16], "little") == 0    # chunk id
    assert int.from_bytes(raw[16:20], "little") == 1    # num frames
    off = int.from_bytes(raw[20:28], "little")
    assert raw[off:off + 4] == b"SEGD"
    assert int.from_bytes(raw[28:36], "little") == 42   # pts
    next_off = int.from_bytes(raw[36:44], "little")
    assert raw[next_off:next_off + 4] == b"TERM"
    assert int.from_bytes(raw[off + 4:off + 8], "little") == 3
    assert raw[off + 8:off + 11] == b"abc"


def test_strip_to_essentials_matches_reference_bytes():
    """Golden fixture: tests/fixtures/strip_reference.bin holds the
    UPSTREAM StripToEssentials output (segmentation_io.cpp:311-440,
    generated by tools/ref_harness/strip_probe on strip_reference.pb);
    our encoder must produce identical bytes."""
    import os
    import struct

    from video_segment_tpu.dataio.seg_io import (SegmentationReader,
                                                 strip_to_essentials)
    from video_segment_tpu import proto

    fx = os.path.join(os.path.dirname(__file__), "fixtures")
    with open(os.path.join(fx, "strip_reference.bin"), "rb") as f:
        (ln,) = struct.unpack("<i", f.read(4))
        ref_bytes = f.read(ln)

    r = SegmentationReader(os.path.join(fx, "strip_reference.pb"))
    assert r.open_and_read_headers()
    desc = proto.SegmentationDesc()
    desc.ParseFromString(next(iter(r)))
    r.close()

    ours = strip_to_essentials(desc, save_vectorization=True,
                               save_shape_moments=False)
    assert bytes(ours) == ref_bytes
