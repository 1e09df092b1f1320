"""Streaming hierarchical region segmentation over chunk sets.

Host driver equivalent of the reference RegionSegmentation
(region_segmentation.{h,cpp}): consumes the dense stage's per-frame results
plus per-frame appearance/flow features, groups them into chunk sets
(default 6 chunks, overlap 2), builds per-region descriptors on device,
agglomerates hierarchy levels, and re-emits frames whose Region2D are the
level-cut regions with the multi-level hierarchy attached
(chunk-set boundary logic: region_segmentation.cpp:97-365).

Cross-set hierarchy continuity uses both halves of the reference's staggered
counterpart exchange (region_segmentation.cpp:143-197): overlap-chunk
regions grouped together at level l of the previous set are force-merged at
level l of the next set (counterpart constraints, see `_process_set` /
agglomeration skeleton merges), and groups inherit the previous set's
hierarchy ids where the carrying region persists (`_inherit_ids`); new
groups take the minimum over-segmentation region id of their members.

Descriptor bookkeeping: per-chunk histogram tables are accumulated on device
once per chunk (keyed by chunk-local region index) and cached on the host,
so overlap chunks re-enter the next set without re-reading pixels.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.core import agglomeration
from video_segment_tpu.core.dense import HierarchyLevelData, SegFrame
from video_segment_tpu.core.options import RegionSegmentationOptions
from video_segment_tpu.segment_util import util


# OpenCV's 8-bit COLOR_BGR2Lab in fixed point: sRGB gamma per channel
# value (x8), the D65 RGB -> XYZ matrix over the white point (x4096), and
# the Lab f(t) curve (x2^15) over the 3*255*8/2 reachable XYZ values.
_GAMMA_X8 = np.rint(2040.0 * np.where(
    np.arange(256) / 255.0 <= 0.04045, np.arange(256) / 255.0 / 12.92,
    ((np.arange(256) / 255.0 + 0.055) / 1.055) ** 2.4)).astype(np.int32)
_XYZ_X4096 = np.rint(4096.0 * np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]])
    / np.array([[0.950456], [1.0], [1.088754]])).astype(np.int32)
_T = np.arange(3072) / 2040.0
_LAB_F = np.rint(32768.0 * np.where(_T < 216.0 / 24389.0,
                                    _T * 841.0 / 108.0 + 16.0 / 116.0,
                                    np.cbrt(_T))).astype(np.int32)


def bgr_to_lab(frame_bgr_u8: np.ndarray) -> np.ndarray:
    """uint8 BGR -> uint8 CIE Lab with OpenCV's 8-bit encoding (L*255/100,
    a+128, b+128): its fixed-point arithmetic, within +-1 of
    cv2.cvtColor(..., COLOR_BGR2Lab)."""
    rgb = _GAMMA_X8[frame_bgr_u8[..., ::-1]]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    fx, fy, fz = (_LAB_F[(c[0] * r + c[1] * g + c[2] * b + 2048) >> 12]
                  for c in _XYZ_X4096.tolist())
    half = 1 << 14
    lum = ((116 * 255 + 50) // 100 * fy
           - (16 * 255 * 32768 + 50) // 100 + half) >> 15
    a = (500 * (fx - fy) + 128 * 32768 + half) >> 15
    b = (200 * (fy - fz) + 128 * 32768 + half) >> 15
    return np.clip(np.stack([lum, a, b], axis=-1), 0, 255).astype(np.uint8)


def _next_pow2(x: int) -> int:
    return 1 << max(4, (x - 1).bit_length())


@functools.partial(jax.jit, static_argnames=("rcap", "lum_bins",
                                             "color_bins", "flow_bins",
                                             "use_flow"))
def _accumulate_all(labels, lab_u8, fbin, fmag, rcap: int, lum_bins: int,
                    color_bins: int, flow_bins: int, use_flow: bool):
    """One fused device call per chunk: color histogram + per-frame flow
    histograms + per-frame vector counts (one upload, one dispatch).

    Color adds are trilinearly interpolated over the (L,a,b) bin lattice,
    exactly like the reference (histograms.cpp:142-199: bin coordinate
    v/255*(bins-1), weight split across the 8 surrounding bins)."""
    tpad = labels.shape[0]
    lflat = labels.reshape(-1)
    nbins = lum_bins * color_bins * color_bins
    lab = lab_u8.reshape(-1, 3).astype(jnp.float32)

    def axis(vals, bins):
        b = vals * ((bins - 1) / 255.0)
        i0 = jnp.floor(b).astype(jnp.int32)
        d = b - i0.astype(jnp.float32)
        i1 = i0 + (d >= 1e-6)
        return ((i0, 1.0 - d), (i1, d))

    xs = axis(lab[:, 0], lum_bins)
    ys = axis(lab[:, 1], color_bins)
    zs = axis(lab[:, 2], color_bins)
    hist = jnp.zeros(rcap * nbins, jnp.float32)
    base = lflat * nbins
    for xi, wx in xs:
        for yi, wy in ys:
            for zi, wz in zs:
                hist = hist.at[
                    base + (xi * color_bins + yi) * color_bins + zi
                ].add(wx * wy * wz)
    hist = hist.reshape(rcap, nbins)
    if not use_flow:
        z = jnp.zeros((0, rcap, flow_bins), jnp.float32)
        return hist, z, jnp.zeros((0, rcap), jnp.float32)
    tkey = (jnp.arange(tpad, dtype=jnp.int32)[:, None, None] * rcap
            + labels).reshape(-1)
    fh = jnp.zeros(tpad * rcap * flow_bins, jnp.float32).at[
        tkey * flow_bins + fbin.reshape(-1).astype(jnp.int32)
    ].add(fmag.reshape(-1).astype(jnp.float32))
    fc = jnp.zeros(tpad * rcap, jnp.float32).at[tkey].add(1.0)
    return (hist, fh.reshape(tpad, rcap, flow_bins),
            fc.reshape(tpad, rcap))


@functools.partial(jax.jit, static_argnames=("rcap", "wcap", "lum_bins",
                                             "color_bins"))
def _accumulate_windowed(labels, lab_u8, gains, win_slot, rcap: int,
                         wcap: int, lum_bins: int, color_bins: int):
    """Per-window gain-calibrated color histograms
    (WindowedAppearanceDescriptor, region_descriptor.cpp:149-205): pixel
    Lab values are scaled by the window's anchor/frame mean gain, clamped
    to 255, and added with trilinear interpolation into a
    (window, region, bin) table.  Returns ((wcap,rcap,B), (wcap,rcap))."""
    nbins = lum_bins * color_bins * color_bins
    lab = jnp.minimum(lab_u8.astype(jnp.float32)
                      * gains[:, None, None, :], 255.0).reshape(-1, 3)
    key = (win_slot[:, None, None] * rcap + labels).reshape(-1)

    def axis(vals, bins):
        b = vals * ((bins - 1) / 255.0)
        i0 = jnp.floor(b).astype(jnp.int32)
        d = b - i0.astype(jnp.float32)
        i1 = i0 + (d >= 1e-6)
        return ((i0, 1.0 - d), (i1, d))

    xs = axis(lab[:, 0], lum_bins)
    ys = axis(lab[:, 1], color_bins)
    zs = axis(lab[:, 2], color_bins)
    hist = jnp.zeros(wcap * rcap * nbins, jnp.float32)
    base = key * nbins
    for xi, wx in xs:
        for yi, wy in ys:
            for zi, wz in zs:
                hist = hist.at[
                    base + (xi * color_bins + yi) * color_bins + zi
                ].add(wx * wy * wz)
    cnt = jnp.zeros(wcap * rcap, jnp.float32).at[key].add(1.0)
    return hist.reshape(wcap, rcap, nbins), cnt.reshape(wcap, rcap)


@dataclasses.dataclass
class _FrameFeatures:
    lab_u8: np.ndarray            # (H,W,3) uint8 Lab
    flow_bin: np.ndarray | None   # (H,W) int8
    flow_mag: np.ndarray | None   # (H,W) float16
    lab_mean: np.ndarray | None = None  # (3,) float32 frame Lab mean


@dataclasses.dataclass
class _ChunkData:
    frames: list                  # SegFrame records (emitted window)
    gids: np.ndarray              # (Rc,) sorted region ids in chunk
    sizes: np.ndarray
    start_frames: np.ndarray
    end_frames: np.ndarray
    neighbor_pairs: np.ndarray
    hist: np.ndarray | None = None       # (Rc, B) float32 host cache
    flow_hist: np.ndarray | None = None  # (Tc, Rc, FB) float32
    flow_cnt: np.ndarray | None = None   # (Tc, Rc) float32
    win_ids: np.ndarray | None = None    # (Wc,) global window indices
    win_hist: np.ndarray | None = None   # (Wc, Rc, B) float32
    win_cnt: np.ndarray | None = None    # (Wc, Rc) float32


class RegionSegmentation:
    def __init__(self, options: RegionSegmentationOptions, frame_width: int,
                 frame_height: int):
        self.options = options
        self.frame_width = frame_width
        self.frame_height = frame_height
        self.num_color_bins = (options.luminance_bins * options.color_bins
                               * options.color_bins)
        self._features: dict[int, _FrameFeatures] = {}
        self._chunks: list[_ChunkData] = []
        self._open_frames: list = []      # SegFrames of the not-yet-closed chunk
        self._set_id = 0
        self._has_flow = False
        # First-frame Lab mean per appearance window (gain anchors) and
        # per-frame Lab means for gain computation.
        self._window_anchor: dict[int, np.ndarray] = {}
        self._frame_means: dict[int, np.ndarray] = {}
        # Per-level (gids, ids) of the previous set's overlap chunks.
        self._prev_assign: list = []

    # -- per-frame feature ingestion -------------------------------------

    def add_frame(self, frame_index: int, frame_bgr_u8: np.ndarray,
                  flow: np.ndarray | None = None):
        """Register appearance (+flow) features for a video frame.

        Computed host-side with NumPy: per-frame device round-trips cost
        more in dispatch latency than this arithmetic."""
        lab = bgr_to_lab(frame_bgr_u8)
        fb = fm = None
        if flow is not None:
            self._has_flow = True
            # FlowField handles serve a half-width (f16) host copy shared
            # with the dense stage's connectedness download — binning is
            # insensitive to the cast, and the exact f32 stays on device.
            if hasattr(flow, "numpy_f16"):
                flow = flow.numpy_f16().astype(np.float32)
            else:
                flow = np.asarray(flow, np.float32)
            ang = (np.arctan2(flow[..., 1], flow[..., 0])
                   / (2.0 * np.pi + 1e-4) + 0.5)
            fb = np.clip((ang * self.options.flow_bins).astype(np.int32),
                         0, self.options.flow_bins - 1).astype(np.int8)
            fm = np.hypot(flow[..., 0], flow[..., 1]).astype(np.float16)
        mean = lab.reshape(-1, 3).mean(axis=0).astype(np.float32)
        self._features[frame_index] = _FrameFeatures(lab, fb, fm, mean)
        self._frame_means[frame_index] = mean
        w = self.options.appearance_window_size
        if w > 0:
            self._window_anchor.setdefault(frame_index // w, mean)

    # -- dense results ingestion -----------------------------------------

    def process_frames(self, flush: bool, seg_frames: list) -> list:
        """Feed dense-stage SegFrames; returns hierarchical SegFrames when a
        chunk set completes (or on flush)."""
        out = []
        for sf in seg_frames:
            if sf.hierarchy is not None and self._open_frames:
                self._close_chunk()
            self._open_frames.append(sf)
            out += self._maybe_process_set(False)
        if flush:
            if self._open_frames:
                self._close_chunk()
            out += self._maybe_process_set(True)
        return out

    # -- chunk bookkeeping ------------------------------------------------

    def _close_chunk(self):
        import os
        import time
        frames = self._open_frames
        self._open_frames = []
        hier = frames[0].hierarchy[0]
        chunk = _ChunkData(
            frames=frames, gids=hier.ids.astype(np.int64),
            sizes=hier.sizes, start_frames=hier.start_frames,
            end_frames=hier.end_frames, neighbor_pairs=hier.neighbor_pairs)
        t0 = time.monotonic()
        self._accumulate_chunk(chunk)
        if os.environ.get("VST_TIMING"):
            import sys
            print(f"[timing] region accumulate_chunk "
                  f"{time.monotonic() - t0:.2f}s ({len(chunk.gids)} regions)",
                  file=sys.stderr, flush=True)
        self._chunks.append(chunk)

    def _accumulate_chunk(self, chunk: _ChunkData):
        """Histogram accumulation for one chunk, cached on host.

        Primary path: the threaded native accumulator
        (native.accumulate_lab_hist — label-range-sharded, race-free,
        deterministic); the scatter-based device path is the fallback.
        Host accumulation also overlaps the device's chunk solves in the
        threaded pipeline."""
        tc = len(chunk.frames)
        rc = len(chunk.gids)
        rcap = _next_pow2(rc + 1)
        if rcap * self.num_color_bins >= 2 ** 31:
            raise ValueError(
                f"chunk has {rc} over-segmented regions — far beyond sane "
                f"density; flat histogram keys would overflow int32 "
                f"(rcap {rcap} * {self.num_color_bins} bins)")
        h, w = self.frame_height, self.frame_width
        labels = np.empty((tc, h, w), np.int32)
        lab_u8 = np.empty((tc, h, w, 3), np.uint8)
        use_flow = self._has_flow
        fbin = np.zeros((tc, h, w), np.int8) if use_flow else None
        fmag = np.zeros((tc, h, w), np.float16) if use_flow else None
        for i, sf in enumerate(chunk.frames):
            idx = np.searchsorted(chunk.gids, sf.region_ids)
            intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
            lab_img = util.rasterize_ids(idx, sf.interval_counts, intervals,
                                         h, w)
            labels[i] = lab_img
            feat = self._features[sf.frame_index]
            lab_u8[i] = feat.lab_u8
            if use_flow and feat.flow_bin is not None:
                fbin[i] = feat.flow_bin
                fmag[i] = feat.flow_mag

        from video_segment_tpu import native
        lum, cb, fb = (self.options.luminance_bins, self.options.color_bins,
                       self.options.flow_bins)
        nat = native.accumulate_lab_hist(labels, lab_u8, rcap, lum, cb)
        if nat is not None:
            chunk.hist = np.ascontiguousarray(nat[0, :rc])
            if use_flow:
                tkey = ((np.arange(tc, dtype=np.int64)[:, None, None] * rcap
                         + labels) * fb + fbin)
                mag = fmag.astype(np.float32)
                fh = native.weighted_bincount(tkey, mag, tc * rcap * fb)
                fc = native.weighted_bincount(
                    tkey // fb, np.ones(tkey.size, np.float32), tc * rcap)
                chunk.flow_hist = fh.reshape(tc, rcap, fb)[:, :rc]
                chunk.flow_cnt = fc.reshape(tc, rcap)[:, :rc]
        else:
            tpad = _next_pow2(tc)
            labels_p = np.full((tpad, h, w), rcap - 1, np.int32)
            labels_p[:tc] = labels
            lab_p = np.zeros((tpad, h, w, 3), np.uint8)
            lab_p[:tc] = lab_u8
            fb_p = np.zeros((tpad, h, w), np.int8)
            fm_p = np.zeros((tpad, h, w), np.float16)
            if use_flow:
                fb_p[:tc] = fbin
                fm_p[:tc] = fmag
            hist, fh, fc = _accumulate_all(
                jnp.asarray(labels_p), jnp.asarray(lab_p),
                jnp.asarray(fb_p) if use_flow
                else jnp.zeros((1, 1, 1), jnp.int8),
                jnp.asarray(fm_p) if use_flow
                else jnp.zeros((1, 1, 1), jnp.float16),
                rcap, lum, cb, fb, use_flow)
            chunk.hist = np.asarray(hist[:rc], np.float32)
            if use_flow:
                chunk.flow_hist = np.asarray(fh[:tc, :rc], np.float32)
                chunk.flow_cnt = np.asarray(fc[:tc, :rc], np.float32)

        wsz = self.options.appearance_window_size
        if wsz > 0:
            wins = sorted({sf.frame_index // wsz for sf in chunk.frames})
            wcap = len(wins) + 1
            if wcap * rcap * self.num_color_bins >= 2 ** 31:
                raise ValueError(
                    f"windowed appearance table too large: {wcap} windows * "
                    f"{rcap} regions * {self.num_color_bins} bins would "
                    f"overflow int32 scatter keys")
            slot_of = {g: i for i, g in enumerate(wins)}
            win_slot = np.full(tc, wcap - 1, np.int32)
            gains = np.ones((tc, 3), np.float32)
            for i, sf in enumerate(chunk.frames):
                feat_mean = self._frame_means[sf.frame_index]
                g = sf.frame_index // wsz
                win_slot[i] = slot_of[g]
                anchor = self._window_anchor.get(g, feat_mean)
                gains[i] = anchor / (feat_mean + 1e-3)
            natw = native.accumulate_lab_hist(
                labels, lab_u8, rcap, lum, cb, gains=gains,
                win_slot=win_slot, wcap=wcap)
            if natw is not None:
                wh, wc = natw, None
                cnt = native.weighted_bincount(
                    win_slot[:, None, None].astype(np.int64) * rcap + labels,
                    np.ones(labels.size, np.float32), wcap * rcap)
                chunk.win_hist = np.ascontiguousarray(wh[:len(wins), :rc])
                chunk.win_cnt = cnt.reshape(wcap, rcap)[:len(wins), :rc]
            else:
                tpad = _next_pow2(tc)
                labels_p = np.full((tpad, h, w), rcap - 1, np.int32)
                labels_p[:tc] = labels
                lab_p = np.zeros((tpad, h, w, 3), np.uint8)
                lab_p[:tc] = lab_u8
                ws_p = np.full(tpad, wcap - 1, np.int32)
                ws_p[:tc] = win_slot
                g_p = np.ones((tpad, 3), np.float32)
                g_p[:tc] = gains
                wh, wc = _accumulate_windowed(
                    jnp.asarray(labels_p), jnp.asarray(lab_p),
                    jnp.asarray(g_p), jnp.asarray(ws_p), rcap, wcap,
                    lum, cb)
                chunk.win_hist = np.asarray(wh[:len(wins), :rc], np.float32)
                chunk.win_cnt = np.asarray(wc[:len(wins), :rc], np.float32)
            chunk.win_ids = np.asarray(wins, np.int64)

        # Features for these frames are no longer needed.
        for sf in chunk.frames:
            self._features.pop(sf.frame_index, None)
            self._frame_means.pop(sf.frame_index, None)

    # -- chunk-set processing ---------------------------------------------

    def _maybe_process_set(self, flush: bool) -> list:
        out = []
        while len(self._chunks) >= self.options.chunk_set_size:
            out += self._process_set(self._chunks[:self.options.chunk_set_size],
                                     emit_all=False)
            keep = self.options.chunk_set_overlap
            self._chunks = self._chunks[self.options.chunk_set_size - keep:]
        if flush and self._chunks:
            out += self._process_set(self._chunks, emit_all=True)
            self._chunks = []
        return out

    def _process_set(self, chunks: list[_ChunkData], emit_all: bool) -> list:
        opts = self.options
        # Union region table across chunks (regions span chunks by id).
        all_gids = np.unique(np.concatenate([c.gids for c in chunks]))
        r = len(all_gids)
        rcap = _next_pow2(r + 1)
        sizes = np.zeros(rcap, np.float32)
        start_f = np.full(r, np.iinfo(np.int32).max, np.int64)
        end_f = np.full(r, -1, np.int64)
        hist = np.zeros((rcap, self.num_color_bins), np.float32)
        t_total = sum(len(c.frames) for c in chunks)
        tcap = _next_pow2(t_total) if self._has_flow else 0
        fh = np.zeros((tcap, rcap, opts.flow_bins), np.float32) \
            if self._has_flow else np.zeros((0, rcap, opts.flow_bins),
                                            np.float32)
        fc = np.zeros((tcap, rcap), np.float32) if self._has_flow else \
            np.zeros((0, rcap), np.float32)

        wsz = self.options.appearance_window_size
        if wsz > 0:
            all_wins = sorted({int(wid) for c in chunks
                               for wid in (c.win_ids if c.win_ids is not None
                                           else [])})
            whist = np.zeros((len(all_wins), rcap, self.num_color_bins),
                             np.float32)
            wcnt = np.zeros((len(all_wins), rcap), np.float32)
        else:
            all_wins = []
            whist = np.zeros((0, rcap, self.num_color_bins), np.float32)
            wcnt = np.zeros((0, rcap), np.float32)

        pair_list = []
        t_off = 0
        for c in chunks:
            idx = np.searchsorted(all_gids, c.gids)
            np.add.at(sizes, idx, c.sizes.astype(np.float32))
            np.minimum.at(start_f, idx, c.start_frames)
            np.maximum.at(end_f, idx, c.end_frames)
            hist[idx] += c.hist.astype(np.float32)
            if self._has_flow and c.flow_hist is not None:
                tc = c.flow_hist.shape[0]
                fh[t_off:t_off + tc, idx] = c.flow_hist.astype(np.float32)
                fc[t_off:t_off + tc, idx] = c.flow_cnt
                t_off += tc
            if wsz > 0 and c.win_hist is not None:
                for wi, wid in enumerate(c.win_ids):
                    slot = all_wins.index(int(wid))
                    whist[slot][idx] += c.win_hist[wi]
                    wcnt[slot][idx] += c.win_cnt[wi]
            if len(c.neighbor_pairs):
                pair_list.append(
                    np.searchsorted(all_gids, c.neighbor_pairs))
        if pair_list:
            pairs = np.unique(np.concatenate(pair_list), axis=0)
        else:
            pairs = np.zeros((0, 2), np.int64)
        ecap = _next_pow2(max(len(pairs), 1))
        edges = np.zeros((ecap, 2), np.int32)
        edges[:len(pairs)] = pairs

        # Counterpart constraints: regions whose members were grouped
        # together at level l of the previous set must stay together at
        # level l here (region_segmentation.cpp:143-197 exchange; forced
        # skeleton merges region_segmentation_graph.cpp:52-71).
        constraints = None
        if getattr(self, "_prev_assign", None):
            constraints = []
            for pg, pid in self._prev_assign:
                carr = np.full(rcap, -1, np.int32)
                if len(pg):
                    pos = np.searchsorted(pg, all_gids)
                    pos_c = np.minimum(pos, len(pg) - 1)
                    has = pg[pos_c] == all_gids
                    if has.any():
                        hidx = np.flatnonzero(has)
                        _, inv = np.unique(pid[pos_c[hidx]],
                                           return_inverse=True)
                        carr[hidx] = inv.astype(np.int32)
                constraints.append(carr)

        import os
        import time
        timing = os.environ.get("VST_TIMING")
        t_ag0 = time.monotonic()
        levels_raw = agglomeration.agglomerate(
            hist, fh, fc, sizes, edges, r,
            min_region_num=opts.min_region_num,
            max_region_num=opts.max_region_num,
            cutoff_fraction=opts.level_cutoff_fraction,
            penalizer=opts.small_region_penalizer,
            use_flow=self._has_flow and opts.use_flow,
            constraints=constraints, win_hist=whist, win_cnt=wcnt,
            reeval_cap=opts.agglo_reeval_cap,
            max_subrounds=opts.agglo_subrounds)
        if not levels_raw:
            levels_raw = [np.arange(rcap, dtype=np.int32)]
        if timing:
            import sys
            print(f"[timing] region agglomerate {time.monotonic() - t_ag0:.2f}s"
                  f" ({r} regions, {len(pairs)} edges, "
                  f"{len(levels_raw)} levels)", file=sys.stderr, flush=True)
        t_emit0 = time.monotonic()

        # Per-level ids: minimum member over-segmentation gid, then inherit
        # the previous set's ids where the carrying region persisted
        # (the reference achieves this with counterpart constraint exchange,
        # region_segmentation.cpp:143-197).
        level_ids = []
        for lab in levels_raw:
            ids = np.full(rcap, np.iinfo(np.int64).max, np.int64)
            np.minimum.at(ids, lab[:r], all_gids)
            level_ids.append(ids)
        level_ids = self._inherit_ids(levels_raw, level_ids, all_gids,
                                      sizes, r)

        hierarchy = self._build_hierarchy(levels_raw, level_ids, r, all_gids,
                                          sizes, start_f, end_f, pairs)

        # Remember the overlap chunks' level assignments for the next set.
        keep = 0 if emit_all else opts.chunk_set_overlap
        if keep:
            ov_gids = np.unique(np.concatenate(
                [c.gids for c in chunks[-keep:]]))
            pos = np.searchsorted(all_gids, ov_gids)
            self._prev_assign = [
                (ov_gids, level_ids[l][levels_raw[l][pos]])
                for l in range(len(levels_raw))]
        else:
            self._prev_assign = []

        # Emit frames of the output window.
        n_emit_chunks = (len(chunks) if emit_all
                         else len(chunks) - opts.chunk_set_overlap)
        out_frames = [sf for c in chunks[:n_emit_chunks] for sf in c.frames]
        lab0 = levels_raw[0]
        ids0 = level_ids[0]
        results = []
        first_idx = out_frames[0].frame_index
        for k, sf in enumerate(out_frames):
            idx = np.searchsorted(all_gids, sf.region_ids)
            draw = ids0[lab0[idx]]
            intervals = np.stack([sf.ys, sf.lxs, sf.rxs], axis=1)
            img = util.rasterize_ids(draw, sf.interval_counts, intervals,
                                     self.frame_height, self.frame_width)
            from video_segment_tpu.ops import rle as rle_ops
            rids, counts, ys, lxs, rxs = rle_ops.frame_rle(img)
            results.append(SegFrame(
                frame_width=self.frame_width,
                frame_height=self.frame_height,
                region_ids=rids, interval_counts=counts,
                ys=ys, lxs=lxs, rxs=rxs,
                moments=rle_ops.shape_moments(counts, ys, lxs, rxs),
                chunk_size=len(out_frames), overlap_start=len(out_frames),
                chunk_id=self._set_id,
                hierarchy_frame_idx=first_idx,
                hierarchy=hierarchy if k == 0 else None,
                frame_index=sf.frame_index))
        self._set_id += 1
        if timing:
            import sys
            print(f"[timing] region set-emit "
                  f"{time.monotonic() - t_emit0:.2f}s "
                  f"({len(results)} frames)", file=sys.stderr, flush=True)
        return results

    def _inherit_ids(self, levels_raw, level_ids, all_gids, sizes, r):
        """Carry hierarchy ids across chunk sets.

        A group inherits a previous-set id X only when the over-segmentation
        region with gid X is one of its members — since members are disjoint,
        inherited ids can never collide with each other or with another
        group's min-gid id (min-gids are members of their own groups).
        Among multiple candidates the group keeps the one with the largest
        carried size."""
        if not getattr(self, "_prev_assign", None):
            return level_ids
        out = []
        for l, lab in enumerate(levels_raw):
            ids = level_ids[l]
            if l >= len(self._prev_assign):
                out.append(ids)
                continue
            pg, pid = self._prev_assign[l]
            pos = np.searchsorted(pg, all_gids)
            pos_c = np.minimum(pos, len(pg) - 1)
            has = (len(pg) > 0) & (pg[pos_c] == all_gids)
            mi = np.flatnonzero(has)
            if not len(mi):
                out.append(ids)
                continue
            roots_m = lab[mi]
            prev_m = pid[pos_c[mi]]
            w_m = sizes[mi]
            # Aggregate vote weight per (root, prev_id).
            order = np.lexsort((prev_m, roots_m))
            rk, pk, wk = roots_m[order], prev_m[order], w_m[order]
            new = np.ones(len(rk), bool)
            new[1:] = (rk[1:] != rk[:-1]) | (pk[1:] != pk[:-1])
            starts = np.flatnonzero(new)
            wsum = np.add.reduceat(wk, starts)
            g_root, g_prev = rk[starts], pk[starts]
            # Membership constraint: prev id X must be carried by a region
            # of this group.
            xpos = np.searchsorted(all_gids, g_prev)
            xpos_c = np.minimum(xpos, r - 1)
            xin = all_gids[xpos_c] == g_prev
            xok = xin & (lab[xpos_c] == g_root)
            g_root, g_prev, wsum = g_root[xok], g_prev[xok], wsum[xok]
            if len(g_root):
                # Highest-weight candidate per root wins.
                order2 = np.lexsort((-wsum, g_root))
                first = np.ones(len(order2), bool)
                rr = g_root[order2]
                first[1:] = rr[1:] != rr[:-1]
                sel = order2[first]
                ids = ids.copy()
                ids[g_root[sel]] = g_prev[sel]
            out.append(ids)
        return out

    def _build_hierarchy(self, levels_raw, level_ids, r, all_gids, sizes,
                         start_f, end_f, pairs):
        """HierarchyLevelData per level: level 0 = the cut regions (childless,
        DiscardBottomLevel semantics), upper levels with parent/child links."""
        out = []
        for l, lab in enumerate(levels_raw):
            roots = np.unique(lab[:r])
            ids = level_ids[l][roots]
            order = np.argsort(ids)
            roots = roots[order]
            ids = ids[order]
            lsizes = np.zeros(len(lab), np.float64)
            np.add.at(lsizes, lab[:r], sizes[:r])
            lstart = np.full(len(lab), np.iinfo(np.int32).max, np.int64)
            lend = np.full(len(lab), -1, np.int64)
            np.minimum.at(lstart, lab[:r], start_f)
            np.maximum.at(lend, lab[:r], end_f)
            if len(pairs):
                lp = level_ids[l][lab[pairs]]
                lp = np.sort(lp, axis=1)
                lp = np.unique(lp[lp[:, 0] != lp[:, 1]], axis=0)
            else:
                lp = np.zeros((0, 2), np.int64)
            parent_ids = None
            if l + 1 < len(levels_raw):
                parent_ids = level_ids[l + 1][levels_raw[l + 1][roots]]
            child_pairs = None
            if l > 0:
                prev_roots = np.unique(levels_raw[l - 1][:r])
                cp_parent = level_ids[l][lab[prev_roots]]
                cp_child = level_ids[l - 1][prev_roots]
                child_pairs = np.stack([cp_parent, cp_child], axis=1)
            out.append(HierarchyLevelData(
                ids=ids, sizes=lsizes[roots].astype(np.int64),
                start_frames=lstart[roots], end_frames=lend[roots],
                neighbor_pairs=lp, parent_ids=parent_ids,
                child_pairs=child_pairs))
        return out
