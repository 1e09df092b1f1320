"""Vectorized wire-format encoding for SegmentationDesc frames.

Encoding one frame of a 1080p segmentation means serializing on the order of
10^5 ScanInterval messages; doing that through Python protobuf objects costs
~1 us per message and would dominate the whole pipeline.  This module emits
the proto2 wire format for the hot part — the `region` list with RLE
rasterizations (reference schema: segment_util/segmentation.proto:56-98) —
directly from NumPy arrays, vectorizing varint layout and byte emission.
The per-chunk hierarchy (`encode_hierarchy_level`) and the scalar fields
are emitted the same way, in field-number order after the regions, so a
frame's bytes equal what the protobuf classes would serialize and no
protobuf runtime is needed to write a stream.

Wire layout emitted per region entry (field numbers < 16 → 1-byte tags):

    0x12 <len: region payload>
      0x08 <varint id>
      0x1A <len: raster payload>
        repeat: 0x0A <len> 0x08 <y> 0x10 <left_x> 0x18 <right_x>
"""

from __future__ import annotations

import numpy as np

_U64 = (1 << 64) - 1


def _varint_len(v: np.ndarray) -> np.ndarray:
    """Byte length of the varint encoding of non-negative int64 values."""
    v = v.astype(np.int64)
    l = np.ones(v.shape, np.int64)
    for k in (7, 14, 21, 28, 35, 42, 49, 56):
        l += v >= (1 << k)
    return l


def _write_varints(buf: np.ndarray, off: np.ndarray, v: np.ndarray,
                   lens: np.ndarray | None = None) -> None:
    """Write varint(v[i]) at buf[off[i]:] for all i (vectorized)."""
    v = v.astype(np.int64)
    if lens is None:
        lens = _varint_len(v)
    max_len = int(lens.max()) if lens.size else 0
    for i in range(max_len):
        m = lens > i
        if i > 0 and not m.any():
            break
        vv = v[m]
        byte = (vv >> (7 * i)) & 0x7F
        cont = (lens[m] - 1) > i
        buf[off[m] + i] = (byte | (cont.astype(np.int64) << 7)).astype(np.uint8)


def encode_varint(v: int) -> bytes:
    """Varint of a Python int; negative values take the 10-byte two's
    complement form protobuf gives int32/int64 fields."""
    out = bytearray()
    v = int(v) & _U64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_MOMENTS_PAYLOAD = 30                    # six 1-byte tags + float32 each
_MOMENTS_ENTRY = 2 + _MOMENTS_PAYLOAD    # 0x2A + len + payload


def encode_regions(region_ids: np.ndarray,
                   interval_counts: np.ndarray,
                   ys: np.ndarray,
                   lxs: np.ndarray,
                   rxs: np.ndarray,
                   moments: np.ndarray | None = None) -> bytes:
    """Serialize the `region` field (repeated Region2D with rasters).

    Args:
      region_ids: (R,) int region ids, ascending (invariant: sorted ids,
        reference segmentation.proto:49-52).
      interval_counts: (R,) number of scan intervals per region; intervals of
        region r occupy the next `interval_counts[r]` slots of ys/lxs/rxs in
        (y, x) lexicographic order.
      ys, lxs, rxs: (I,) scanline y, left_x, right_x (inclusive) per interval.
      moments: optional (R,6) float32 ShapeMoments
        [size, mean_x, mean_y, moment_xx, moment_xy, moment_yy].
    """
    region_ids = np.asarray(region_ids, np.int64)
    interval_counts = np.asarray(interval_counts, np.int64)
    ys = np.asarray(ys, np.int64)
    lxs = np.asarray(lxs, np.int64)
    rxs = np.asarray(rxs, np.int64)
    R = region_ids.shape[0]
    if R == 0:
        return b""

    sy = _varint_len(ys)
    sl = _varint_len(lxs)
    sr = _varint_len(rxs)
    ipayload = 3 + sy + sl + sr          # three 1-byte tags + varints
    ientry = 2 + ipayload                # 0x0A + 1-byte len (payload <= 29)

    starts = np.zeros(R, np.int64)
    starts[1:] = np.cumsum(interval_counts[:-1])
    ends = starts + interval_counts
    centry = np.concatenate(([0], np.cumsum(ientry)))
    raster_len = centry[ends] - centry[starts]

    m_entry = _MOMENTS_ENTRY if moments is not None else 0
    s_id = _varint_len(region_ids)
    s_rlen = _varint_len(raster_len)
    region_payload = (1 + s_id) + (1 + s_rlen) + raster_len + m_entry
    s_rp = _varint_len(region_payload)
    region_entry = 1 + s_rp + region_payload

    rstart = np.concatenate(([0], np.cumsum(region_entry)))
    total = int(rstart[-1])
    buf = np.zeros(total, np.uint8)

    # Region entry headers.
    buf[rstart[:-1]] = 0x12
    o = rstart[:-1] + 1
    _write_varints(buf, o, region_payload, s_rp)
    o = o + s_rp
    buf[o] = 0x08
    _write_varints(buf, o + 1, region_ids, s_id)
    o = o + 1 + s_id
    buf[o] = 0x1A
    _write_varints(buf, o + 1, raster_len, s_rlen)
    iblock = o + 1 + s_rlen              # start of this region's intervals

    if moments is not None:
        # Fixed 32-byte shape_moments block after the raster.
        m = np.ascontiguousarray(moments, "<f4").view(np.uint8).reshape(R, 6, 4)
        mo = (iblock + raster_len)[:, None]
        buf[mo[:, 0]] = 0x2A
        buf[mo[:, 0] + 1] = _MOMENTS_PAYLOAD
        tags = np.arange(1, 7, dtype=np.uint8) << 3 | 5  # wire type 5
        pos = mo + 2 + np.arange(6)[None, :] * 5
        buf[pos] = tags[None, :]
        for b_i in range(4):
            buf[pos + 1 + b_i] = m[:, :, b_i]

    # Interval entries: global offset = region block start + intra-region csum.
    region_of = np.repeat(np.arange(R), interval_counts)
    ioff = iblock[region_of] + (centry[:-1] - centry[starts][region_of])

    buf[ioff] = 0x0A
    buf[ioff + 1] = ipayload.astype(np.uint8)
    buf[ioff + 2] = 0x08
    _write_varints(buf, ioff + 3, ys, sy)
    o = ioff + 3 + sy
    buf[o] = 0x10
    _write_varints(buf, o + 1, lxs, sl)
    o = o + 1 + sl
    buf[o] = 0x18
    _write_varints(buf, o + 1, rxs, sr)

    return buf.tobytes()


def encode_hierarchy_level(ids: np.ndarray,
                           sizes: np.ndarray,
                           start_frames: np.ndarray,
                           end_frames: np.ndarray,
                           neighbor_counts: np.ndarray,
                           neighbor_ids: np.ndarray,
                           parent_ids: np.ndarray | None = None,
                           child_counts: np.ndarray | None = None,
                           child_ids: np.ndarray | None = None) -> bytes:
    """Serialize one HierarchyLevel message body (`repeated CompoundRegion
    region = 2`, reference schema segmentation.proto:100-116).

    Region r lists the next `neighbor_counts[r]` entries of `neighbor_ids`
    (and of `child_ids`, if given) as its neighbors (children).  Every
    CompoundRegion field is a varint with a 1-byte tag, so a region is a
    run of (tag, varint) tokens in field-number order: id 1, size 2,
    neighbor_id 3 (unpacked), parent_id 4, child_id 5, start_frame 6,
    end_frame 7.  Values must be non-negative.
    """
    ids = np.asarray(ids, np.int64)
    r = ids.shape[0]
    if r == 0:
        return b""
    regions = np.arange(r)
    cols = [(1, regions, ids), (2, regions, sizes),
            (3, np.repeat(regions, neighbor_counts), neighbor_ids)]
    if parent_ids is not None:
        cols.append((4, regions, parent_ids))
    if child_ids is not None:
        cols.append((5, np.repeat(regions, child_counts), child_ids))
    cols += [(6, regions, start_frames), (7, regions, end_frames)]
    rec = np.concatenate([c[1] for c in cols])
    field = np.concatenate([np.full(len(c[1]), c[0], np.int64)
                            for c in cols])
    vals = np.concatenate([np.asarray(c[2], np.int64).reshape(-1)
                           for c in cols])
    if (vals < 0).any():
        raise ValueError("hierarchy values must be non-negative")
    order = np.lexsort((field, rec))          # stable: lists keep order
    rec, field, vals = rec[order], field[order], vals[order]

    vlen = _varint_len(vals)
    tok = 1 + vlen
    payload = np.bincount(rec, tok, minlength=r).astype(np.int64)
    s_pl = _varint_len(payload)
    entry = 1 + s_pl + payload
    rstart = np.concatenate(([0], np.cumsum(entry)))
    buf = np.zeros(int(rstart[-1]), np.uint8)
    buf[rstart[:-1]] = 0x12                    # HierarchyLevel.region = 2
    _write_varints(buf, rstart[:-1] + 1, payload, s_pl)
    body = rstart[:-1] + 1 + s_pl              # first token of each region
    ctok = np.concatenate(([0], np.cumsum(tok)))
    first = np.searchsorted(rec, regions)      # rec is sorted
    toff = body[rec] + ctok[:-1] - ctok[first][rec]
    buf[toff] = (field << 3).astype(np.uint8)  # wire type 0
    _write_varints(buf, toff + 1, vals, vlen)
    return buf.tobytes()


def encode_frame(region_ids: np.ndarray,
                 interval_counts: np.ndarray,
                 ys: np.ndarray,
                 lxs: np.ndarray,
                 rxs: np.ndarray,
                 moments: np.ndarray | None = None,
                 *,
                 frame_width: int,
                 frame_height: int,
                 chunk_size: int | None = None,
                 overlap_start: int | None = None,
                 chunk_id: int | None = None,
                 hierarchy_frame_idx: int | None = None,
                 connectedness: int | None = None,
                 hierarchy: list | None = None) -> bytes:
    """Serialize a full SegmentationDesc for one frame.

    `hierarchy` is an optional list of serialized HierarchyLevel message
    bodies (`encode_hierarchy_level`).
    """
    out = [encode_regions(region_ids, interval_counts, ys, lxs, rxs,
                          moments)]
    for level in hierarchy or ():
        out.append(b"\x1a" + encode_varint(len(level)) + level)
    for field, value in ((4, frame_width), (5, frame_height),
                         (6, chunk_size), (7, overlap_start),
                         (8, chunk_id), (9, hierarchy_frame_idx),
                         (12, connectedness)):
        if value is not None:
            out.append(bytes([field << 3]) + encode_varint(value))
    return b"".join(out)


def decode_rasterizations(desc) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (region_ids, interval_counts, intervals[y,lx,rx]) from a parsed
    SegmentationDesc (protobuf object)."""
    ids = []
    counts = []
    rows = []
    for r in desc.region:
        ids.append(r.id)
        counts.append(len(r.raster.scan_inter))
        for si in r.raster.scan_inter:
            rows.append((si.y, si.left_x, si.right_x))
    intervals = np.array(rows, np.int32).reshape(-1, 3)
    return (np.array(ids, np.int32), np.array(counts, np.int32), intervals)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field number, wire type, value) over one message's bytes;
    LEN values are bytes, varints ints, fixed32/64 raw bytes."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        wt = key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield key >> 3, wt, v


def _int32(v: int) -> int:
    """Varint payload of an int32 field (negatives are 64-bit two's
    complement on the wire)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _ints(wt: int, v) -> list:
    """A repeated int32 field entry, unpacked (varint) or packed (LEN)."""
    if wt == 0:
        return [_int32(v)]
    out, i = [], 0
    while i < len(v):
        x, i = _read_varint(v, i)
        out.append(_int32(x))
    return out


def decode_frame(payload: bytes) -> dict:
    """Parse SegmentationDesc wire bytes without the protobuf runtime.

    Returns the scalar fields by name, `region_ids` (R,), `interval_counts`
    (R,) and `intervals` (I,3) [y, left_x, right_x] in stream order, and
    `hierarchy`: one dict per HierarchyLevel with per-region `ids`,
    `sizes`, `parent_ids` (-1 unset), `neighbors` and `children` (lists),
    `start_frames` and `end_frames`.  Vectorizations and features are
    skipped."""
    names = {4: "frame_width", 5: "frame_height", 6: "chunk_size",
             7: "overlap_start", 8: "chunk_id", 9: "hierarchy_frame_idx",
             12: "connectedness", 13: "rasterization_removed"}
    out = {"frame_width": 0, "frame_height": 0, "chunk_id": -1,
           "hierarchy_frame_idx": 0, "hierarchy": []}
    ids, counts, rows = [], [], []
    for f, wt, v in _fields(payload):
        if f in names and wt == 0:
            out[names[f]] = _int32(v)
        elif f == 2:
            rid, n = 0, 0
            for rf, _, rv in _fields(v):
                if rf == 1:
                    rid = _int32(rv)
                elif rf == 3:
                    for _, _, si in _fields(rv):
                        iv = [0, 0, 0]
                        for sf, _, x in _fields(si):
                            iv[sf - 1] = _int32(x)
                        rows.append(iv)
                        n += 1
            ids.append(rid)
            counts.append(n)
        elif f == 3:
            out["hierarchy"].append(_decode_level(v))
    out["region_ids"] = np.array(ids, np.int64)
    out["interval_counts"] = np.array(counts, np.int64)
    out["intervals"] = np.array(rows, np.int64).reshape(-1, 3)
    return out


def _decode_level(buf: bytes) -> dict:
    lvl = {k: [] for k in ("ids", "sizes", "parent_ids", "neighbors",
                           "children", "start_frames", "end_frames")}
    for f, _, v in _fields(buf):
        if f != 2:
            continue
        r = {1: 0, 2: 0, 4: -1, 6: 0, 7: 0}
        nb, ch = [], []
        for cf, cwt, cv in _fields(v):
            if cf == 3:
                nb += _ints(cwt, cv)
            elif cf == 5:
                ch += _ints(cwt, cv)
            elif cf in r:
                r[cf] = _int32(cv)
        for key, fld in (("ids", 1), ("sizes", 2), ("parent_ids", 4),
                         ("start_frames", 6), ("end_frames", 7)):
            lvl[key].append(r[fld])
        lvl["neighbors"].append(nb)
        lvl["children"].append(ch)
    return lvl
