"""Streaming dense segmentation: chunking, id consistency, proto emission."""

import numpy as np
import pytest

from video_segment_tpu import proto
from video_segment_tpu.core import dense
from video_segment_tpu.core.options import DenseSegmentationOptions
from video_segment_tpu.dataio import emit, fast_proto


def _synthetic_video(n_frames, h=24, w=32):
    """A bright square moving right over a dark background."""
    frames = []
    for f in range(n_frames):
        img = np.full((h, w, 3), 40, np.uint8)
        x0 = 2 + f
        img[8:16, x0:x0 + 8] = 220
        frames.append(img)
    return frames


def _run(frames, chunk_size=5, **opt_kw):
    opts = DenseSegmentationOptions(chunk_size=chunk_size,
                                    presmoothing="gaussian",
                                    frac_min_region_size=0.05, **opt_kw)
    ds = dense.DenseSegmentation(opts, frames[0].shape[1], frames[0].shape[0])
    results = []
    for fr in frames:
        results += ds.process_frame(False, fr)
    results += ds.process_frame(True)
    return results


def _label_image(sf):
    img = np.full((sf.frame_height, sf.frame_width), -1, np.int64)
    pos = 0
    for i, rid in enumerate(sf.region_ids):
        for _ in range(sf.interval_counts[i]):
            y, l, r = sf.ys[pos], sf.lxs[pos], sf.rxs[pos]
            img[y, l:r + 1] = rid
            pos += 1
    return img


def test_streaming_emits_every_frame_once():
    frames = _synthetic_video(12)
    results = _run(frames)
    assert [sf.frame_index for sf in results] == list(range(12))


def test_full_coverage_and_sorted_ids():
    frames = _synthetic_video(12)
    for sf in _run(frames):
        img = _label_image(sf)
        assert (img >= 0).all(), f"frame {sf.frame_index} has unlabeled pixels"
        assert (np.diff(sf.region_ids) > 0).all()


def test_temporal_id_consistency_across_chunks():
    frames = _synthetic_video(12)
    results = _run(frames)
    # Track the id of the moving square's center and the background corner.
    sq_ids = []
    bg_ids = []
    for sf in results:
        img = _label_image(sf)
        f = sf.frame_index
        sq_ids.append(img[12, 2 + f + 4])
        bg_ids.append(img[0, 0])
    assert len(set(sq_ids)) == 1, f"square id changed across chunks: {sq_ids}"
    assert len(set(bg_ids)) == 1, f"background id changed: {bg_ids}"
    assert sq_ids[0] != bg_ids[0]


def test_hierarchy_on_chunk_start_frames():
    frames = _synthetic_video(12)
    results = _run(frames)
    with_h = [sf for sf in results if sf.hierarchy is not None]
    assert len(with_h) >= 2  # one per chunk
    h0 = with_h[0].hierarchy[0]
    assert (np.diff(h0.ids) > 0).all()
    assert (h0.sizes > 0).all()
    # Square and background are neighbors.
    assert len(h0.neighbor_pairs) >= 1


def test_proto_roundtrip_with_hierarchy():
    frames = _synthetic_video(7)
    results = _run(frames, chunk_size=7)
    payload = emit.segframe_to_bytes(results[0])
    msg = proto.SegmentationDesc()
    msg.ParseFromString(payload)
    assert msg.frame_width == 32 and msg.frame_height == 24
    assert len(msg.hierarchy) == 1
    level = msg.hierarchy[0]
    assert len(level.region) == len(results[0].hierarchy[0].ids)
    for cr in level.region:
        assert cr.size > 0
        assert list(cr.neighbor_id) == sorted(cr.neighbor_id)
    ids, counts, intervals = fast_proto.decode_rasterizations(msg)
    assert (ids == results[0].region_ids).all()


def test_flush_mid_chunk():
    frames = _synthetic_video(8)
    results = _run(frames, chunk_size=6)
    assert [sf.frame_index for sf in results] == list(range(8))


def test_felz_per_frame_preseg_mode(rng):
    """The felz preseg path (per-frame dispatch at ingest) streams
    correctly: full coverage, constrained chunk seams, id continuity."""
    import dataclasses

    from video_segment_tpu.core import dense
    from video_segment_tpu.core.options import DenseSegmentationOptions

    w, h = 32, 24
    opts = DenseSegmentationOptions(chunk_size=4, preseg_mode="felz")
    ds = dense.DenseSegmentation(opts, w, h)
    frames = []
    base = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    for i in range(9):
        f = base.copy()
        f[:, : 8 + i] = (200, 30, 40)
        frames.append(f)
    out = []
    for f in frames:
        out += ds.process_frame(False, f)
    out += ds.process_frame(True)
    assert [sf.frame_index for sf in out] == list(range(9))
    for sf in out:
        area = int(sum(sf.rxs - sf.lxs + 1))
        assert area == w * h
        assert list(sf.region_ids) == sorted(sf.region_ids)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_preseg_is_felz_on_every_backend(monkeypatch, backend):
    """One pre-segmentation choice, with no platform branch: the default
    options take the felz pre-solve (and its tighter region table)
    whatever backend JAX reports."""
    import jax

    from video_segment_tpu.core import dense
    from video_segment_tpu.core.options import DenseSegmentationOptions

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    ds = dense.DenseSegmentation(DenseSegmentationOptions(), 64, 48)
    assert ds._preseg_mode == "felz"
    assert ds._params.table_divisor == 16
    ds = dense.DenseSegmentation(
        DenseSegmentationOptions(preseg_mode="flood"), 64, 48)
    assert ds._preseg_mode == "flood"
    with pytest.raises(ValueError):
        dense.DenseSegmentation(DenseSegmentationOptions(preseg_mode="auto"),
                                64, 48)


def test_async_tail_matches_sync():
    """options.async_tail defers the host tail one chunk; the emitted
    stream (order, ids, rasters, hierarchy) must be identical."""
    frames = _synthetic_video(13)
    sync = _run(frames)
    asyn = _run(frames, async_tail=True)
    assert [sf.frame_index for sf in sync] == [sf.frame_index for sf in asyn]
    for a, b in zip(sync, asyn):
        np.testing.assert_array_equal(_label_image(a), _label_image(b))
        np.testing.assert_array_equal(a.region_ids, b.region_ids)
        assert (a.hierarchy is None) == (b.hierarchy is None)
        if a.hierarchy is not None:
            np.testing.assert_array_equal(a.hierarchy[0].ids,
                                          b.hierarchy[0].ids)
            np.testing.assert_array_equal(a.hierarchy[0].neighbor_pairs,
                                          b.hierarchy[0].neighbor_pairs)
