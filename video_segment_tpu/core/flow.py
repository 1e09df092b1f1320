"""Dense TV-L1 optical flow on the device (jnp) + flow caching.

Replaces the reference's OpenCV DualTVL1 engine
(video_framework/flow_reader.cpp:180-330; settings warps=2, iterations=10
from seg_tree_sample/seg_tree.cpp:174-175) with a JAX implementation of
Zach et al.'s duality-based TV-L1 (the algorithm OpenCV implements): image
pyramid, per-scale warping, pointwise thresholding step on the data term and
Chambolle dual updates on the smoothness term.  Everything is stencil math —
it fuses into a single XLA program per pyramid scale.

The `.flow` cache file is byte-compatible with the reference
(flow_reader.cpp:239-249): int32 width/height/flow_type header followed by
raw float32 interleaved (x,y) fields, one per frame from the second frame on.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class TVL1Params(NamedTuple):
    tau: float = 0.25
    lambda_: float = 0.15
    theta: float = 0.3
    # Depth is bounded by the >= 16px level floor below, so nscales is a
    # cap, not the operative rule: 8 lets 1080p descend to a ~16-row
    # coarsest level (5 stopped at 67 rows — too fine to lock a large
    # pan before linearization breaks at the finer scales).
    nscales: int = 8
    # The reference runs warps=2 / iterations=10 (seg_tree.cpp:174-175) on
    # OpenCV's scheme; our primal-dual scheme needs more inner iterations
    # to converge.  3x40 measured strictly better than the old 4x100 on
    # the real-content Farneback oracle (warp MAD 4.49 vs 4.62, median
    # EPE 0.486 vs 0.490) at 3.3x less inner work — past convergence the
    # extra iterations only drift the solution; flow device time is the
    # dominant config-3 cost, so the defaults sit at the quality knee.
    warps: int = 3
    iterations: int = 40
    # Finest-scale schedule: inner work concentrates at full resolution
    # (scale s costs 4^-s of scale 0), but the solution there only refines
    # the upsampled coarse field.  2x20 at scale 0 measures within 1-4%
    # warp MAD of 3x40 on real content across slow and fast motion at
    # ~0.5x total inner work (round-5 sweep vs the Farneback oracle).
    fine_warps: int = 2
    fine_iterations: int = 20
    epsilon: float = 0.01


def _downsample2(img):
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def _resize_bilinear(img, out_h, out_w):
    h, w = img.shape[-2:]
    ys = (jnp.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (jnp.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, h - 1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    wy = jnp.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = jnp.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[..., y0, :][..., :, x0]
    b = img[..., y0, :][..., :, x1]
    c = img[..., y1, :][..., :, x0]
    d = img[..., y1, :][..., :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def _warp(img, u1, u2):
    """Bilinear sample img at (x+u1, y+u2), clamped."""
    h, w = img.shape
    ys = jnp.arange(h)[:, None] + u2
    xs = jnp.arange(w)[None, :] + u1
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, h - 1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    wy = jnp.clip(ys - y0, 0.0, 1.0)
    wx = jnp.clip(xs - x0, 0.0, 1.0)
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * w + xx]

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def _grad(img):
    """Central differences (forward at borders)."""
    gx = jnp.zeros_like(img)
    gy = jnp.zeros_like(img)
    gx = gx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    gx = gx.at[:, 0].set(img[:, 1] - img[:, 0])
    gx = gx.at[:, -1].set(img[:, -1] - img[:, -2])
    gy = gy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    gy = gy.at[0, :].set(img[1, :] - img[0, :])
    gy = gy.at[-1, :].set(img[-1, :] - img[-2, :])
    return gx, gy


def _forward_diff(u):
    ux = jnp.zeros_like(u)
    uy = jnp.zeros_like(u)
    ux = ux.at[:, :-1].set(u[:, 1:] - u[:, :-1])
    uy = uy.at[:-1, :].set(u[1:, :] - u[:-1, :])
    return ux, uy


def _divergence(p1, p2):
    """Backward-difference divergence (adjoint of forward gradient)."""
    d1 = jnp.zeros_like(p1)
    d1 = d1.at[:, 0].set(p1[:, 0])
    d1 = d1.at[:, 1:-1].set(p1[:, 1:-1] - p1[:, :-2])
    d1 = d1.at[:, -1].set(-p1[:, -2])
    d2 = jnp.zeros_like(p2)
    d2 = d2.at[0, :].set(p2[0, :])
    d2 = d2.at[1:-1, :].set(p2[1:-1, :] - p2[:-2, :])
    d2 = d2.at[-1, :].set(-p2[-2, :])
    return d1 + d2


def _tvl1_scale(i0, i1, u1, u2, p: TVL1Params):
    """Warps + primal-dual iterations at one pyramid scale."""
    i1x, i1y = _grad(i1)
    l_t = p.lambda_ * p.theta
    taut = p.tau / p.theta

    p11 = jnp.zeros_like(i0)
    p12 = jnp.zeros_like(i0)
    p21 = jnp.zeros_like(i0)
    p22 = jnp.zeros_like(i0)

    for _ in range(p.warps):
        i1w = _warp(i1, u1, u2)
        i1wx = _warp(i1x, u1, u2)
        i1wy = _warp(i1y, u1, u2)
        grad2 = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0

        def body(_, carry):
            u1, u2, p11, p12, p21, p22 = carry
            rho = rho_c + i1wx * u1 + i1wy * u2
            # Thresholding step on the data term.
            d1 = jnp.where(rho < -l_t * grad2, l_t * i1wx,
                           jnp.where(rho > l_t * grad2, -l_t * i1wx,
                                     -rho * i1wx / jnp.maximum(grad2, 1e-9)))
            d2 = jnp.where(rho < -l_t * grad2, l_t * i1wy,
                           jnp.where(rho > l_t * grad2, -l_t * i1wy,
                                     -rho * i1wy / jnp.maximum(grad2, 1e-9)))
            v1 = u1 + d1
            v2 = u2 + d2
            # Dual ascent on the TV term.
            u1n = v1 + p.theta * _divergence(p11, p12)
            u2n = v2 + p.theta * _divergence(p21, p22)
            u1x, u1y = _forward_diff(u1n)
            u2x, u2y = _forward_diff(u2n)
            ng1 = 1.0 + taut * jnp.hypot(u1x, u1y)
            ng2 = 1.0 + taut * jnp.hypot(u2x, u2y)
            return (u1n, u2n,
                    (p11 + taut * u1x) / ng1, (p12 + taut * u1y) / ng1,
                    (p21 + taut * u2x) / ng2, (p22 + taut * u2y) / ng2)

        u1, u2, p11, p12, p21, p22 = jax.lax.fori_loop(
            0, p.iterations, body, (u1, u2, p11, p12, p21, p22))
    return u1, u2


def _tvl1_flow_impl(i0: jnp.ndarray, i1: jnp.ndarray,
                    params: TVL1Params) -> jnp.ndarray:
    # lambda_ = 0.15 is calibrated for 8-bit-range intensities (OpenCV's
    # DualTVL1 keeps CV_8U inputs at 0..255): on [0,1] inputs the data
    # term is ~255x weaker than the TV term and real-content flow
    # undershoots ~2x (warp error worse than zero flow — measured).  Scale
    # internally so the public [0,1] convention stays.
    i0 = i0 * 255.0
    i1 = i1 * 255.0
    pyr0 = [i0]
    pyr1 = [i1]
    for _ in range(params.nscales - 1):
        # Every level must keep min-dim >= 16: the old check-before-append
        # admitted one sub-16 level (e.g. 8x15 from 240x136), and a solve
        # that tiny overshoots large global motion ~2x — finer scales
        # cannot pull a wrong coarse init back once the residual exceeds
        # the linearization range (measured vs the DualTVL1 oracle:
        # warp MAD 31.0 -> 21.5 on a 17.8px-mean pan pair from the fix).
        if min(pyr0[-1].shape) // 2 < 16:
            break
        pyr0.append(_downsample2(pyr0[-1]))
        pyr1.append(_downsample2(pyr1[-1]))

    u1 = jnp.zeros_like(pyr0[-1])
    u2 = jnp.zeros_like(pyr0[-1])
    for s in range(len(pyr0) - 1, -1, -1):
        if u1.shape != pyr0[s].shape:
            sy = pyr0[s].shape[0] / u1.shape[0]
            sx = pyr0[s].shape[1] / u1.shape[1]
            u1 = _resize_bilinear(u1, *pyr0[s].shape) * sx
            u2 = _resize_bilinear(u2, *pyr0[s].shape) * sy
        p = (params._replace(warps=params.fine_warps,
                             iterations=params.fine_iterations)
             if s == 0 else params)
        u1, u2 = _tvl1_scale(pyr0[s], pyr1[s], u1, u2, p)
    return jnp.stack([u1, u2], axis=-1)


@functools.partial(jax.jit, static_argnames=("params",))
def tvl1_flow(i0: jnp.ndarray, i1: jnp.ndarray,
              params: TVL1Params = TVL1Params()) -> jnp.ndarray:
    """Dense flow from i0 to i1 (grayscale float [0,1], (H,W)); (H,W,2)."""
    return _tvl1_flow_impl(i0, i1, params)


@functools.partial(jax.jit, static_argnames=("params",))
def tvl1_flow_batch(i0s: jnp.ndarray, i1s: jnp.ndarray,
                    params: TVL1Params = TVL1Params()) -> jnp.ndarray:
    """Batched flow over B frame pairs ((B,H,W) -> (B,H,W,2)) in ONE device
    program — amortizes dispatch and lets XLA schedule the pyramid stencil
    chains across pairs (the reference computes pairs one at a time on its
    flow thread, flow_reader.cpp:257-363)."""
    return jax.vmap(lambda a, b: _tvl1_flow_impl(a, b, params))(i0s, i1s)


def bgr_to_gray(frame_bgr_u8: np.ndarray) -> np.ndarray:
    """BT.601 luminance in [0,1] (LuminanceUnit, conversion_units.cpp)."""
    f = frame_bgr_u8.astype(np.float32)
    return (0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]) / 255.0


FLOW_FORWARD = 0
FLOW_BACKWARD = 1
FLOW_BOTH = 2


class _LazyFlowBatch:
    """Shared host cache for one micro-batch of device flow fields.

    The first host consumer triggers ONE float16 download of the whole
    (B,H,W,2) batch (half the bytes of f32, one transfer instead of B);
    every FlowField of the batch then serves
    its slice from the cache.  Flow magnitudes are a few pixels, so f16
    (~3 decimal digits) is far inside the tolerance of every host
    consumer: centroid advection (threshold 4% of the frame diagonal,
    core/connectedness.py) and angle/magnitude histogram binning
    (core/region.py)."""

    __slots__ = ("dev", "_f16")

    def __init__(self, dev):
        self.dev = dev          # (B,H,W,2) float32 device array
        self._f16 = None

    def f16(self, i: int) -> np.ndarray:
        if self._f16 is None:
            self._f16 = np.asarray(_to_f16(self.dev))
        return self._f16[i]


@jax.jit
def _to_f16(x):
    return x.astype(jnp.float16)


class FlowField:
    """Handle for one frame's (H,W,2) flow field.

    Device-resident when computed on the device: the dense solver reads
    `.device()` and skips a download + re-upload round-trip (~8 bytes/px
    each way).  Host consumers go
    through `.numpy_f16()` (batched half-width download, cached) or
    `np.asarray(field)` (exact float32 — used by the `.flow` cache
    writer).  Mirrors the reference's FlowFrame payload
    (video_framework/flow_reader.h:76-133) with the storage residency
    made explicit."""

    __slots__ = ("_dev", "_host", "_batch", "_idx")

    def __init__(self, dev=None, host=None, batch=None, idx=0):
        self._dev = dev
        self._host = None if host is None else np.asarray(host, np.float32)
        self._batch = batch
        self._idx = idx

    def device(self):
        """(H,W,2) float32 on device (uploads once for host-backed fields)."""
        if self._dev is None:
            self._dev = jnp.asarray(self.numpy())
        return self._dev

    def numpy(self) -> np.ndarray:
        """Exact float32 host copy (downloads once)."""
        if self._host is None:
            self._host = np.asarray(self._dev, np.float32)
        return self._host

    def numpy_f16(self) -> np.ndarray:
        """Half-width host copy for tolerance-insensitive consumers; serves
        the exact copy when one already exists (cache-read path)."""
        if self._host is not None:
            return self._host
        if self._batch is not None:
            return self._batch.f16(self._idx)
        return self.numpy()

    @property
    def shape(self):
        src = self._host if self._host is not None else self._dev
        return tuple(src.shape)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None and a.dtype != np.dtype(dtype):
            return a.astype(dtype)
        return a.copy() if copy else a


def as_flow_host(flow, prefer_f16: bool = True) -> np.ndarray | None:
    """Host array view of a flow argument (FlowField or ndarray or None)."""
    if flow is None:
        return None
    if isinstance(flow, FlowField):
        return flow.numpy_f16() if prefer_f16 else flow.numpy()
    return np.asarray(flow)


class FlowPair(NamedTuple):
    """Per-frame flow fields when flow_type != FLOW_BACKWARD
    (flow_reader.cpp:277-303: forward = calc(prev, cur), backward =
    calc(cur, prev), both attached to the current frame)."""

    forward: np.ndarray | None
    backward: np.ndarray | None


def flow_to_hsv_bgr(flow: np.ndarray) -> np.ndarray:
    """Render a flow field as a BGR image: hue from flow angle, saturation
    and value from magnitude (flow_reader.cpp:306-330 formula exactly:
    H=(atan2(y,x)/pi+1)*90, S=V=min(|f|*20, 255))."""
    import cv2

    flow = as_flow_host(flow)
    x, y = flow[..., 0], flow[..., 1]
    hsv = np.empty((*x.shape, 3), np.uint8)
    hsv[..., 0] = ((np.arctan2(y, x) / np.pi + 1.0) * 90.0).astype(np.uint8)
    mag = np.minimum(np.hypot(x, y) * 20.0, 255.0).astype(np.uint8)
    hsv[..., 1] = mag
    hsv[..., 2] = mag
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


class FlowCacheWriter:
    """Reference-compatible .flow file writer (flow_reader.cpp:239-249)."""

    def __init__(self, path: str, width: int, height: int,
                 flow_type: int = FLOW_BACKWARD):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<iii", width, height, flow_type))

    def write(self, flow: np.ndarray):
        self._f.write(np.ascontiguousarray(flow, np.float32).tobytes())

    def close(self):
        self._f.close()


class FlowCacheReader:
    """Reference-compatible .flow file reader."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self.width, self.height, self.flow_type = struct.unpack(
            "<iii", self._f.read(12))
        self._frame_bytes = self.width * self.height * 2 * 4

    def read(self) -> np.ndarray | None:
        buf = self._f.read(self._frame_bytes)
        if len(buf) < self._frame_bytes:
            return None
        return np.frombuffer(buf, np.float32).reshape(
            self.height, self.width, 2)

    def close(self):
        self._f.close()


class FlowEngine:
    """Streaming flow provider with transparent .flow caching
    (seg_tree.cpp:120-126: reuse <input>.flow when present).

    `flow_type` selects the reference's DenseFlowOptions.flow_type
    (flow_reader.h:145-151): BACKWARD (default — what segmentation
    consumes; triples carry a plain (H,W,2) array), FORWARD or BOTH
    (triples carry a `FlowPair`).  For BOTH the `.flow` cache stores
    forward then backward per frame, matching the reference reader's
    "first forward then backward" stream order (flow_reader.h:103).

    Two usage styles:
    - `compute(frame, idx)` — synchronous per-frame (one device call each).
    - `push(frame, idx)` / `flush()` — micro-batched: frames accumulate until
      `batch` pairs are ready, then ONE vmapped device call computes them all
      and the completed (idx, frame, flow) triples are returned (in order).
    """

    def __init__(self, width: int, height: int, cache_path: str | None = None,
                 params: TVL1Params = TVL1Params(), batch: int = 6,
                 flow_type: int = FLOW_BACKWARD):
        self.params = params
        self.batch = max(batch, 1)
        self.flow_type = flow_type
        self._pending: list[tuple[int, np.ndarray, np.ndarray]] = []
        self._prev_gray: np.ndarray | None = None
        self._reader = None
        self._writer = None
        if cache_path and os.path.exists(cache_path):
            try:
                r = FlowCacheReader(cache_path)
                if (r.width, r.height) == (width, height):
                    self._reader = r
                    self.flow_type = r.flow_type
                else:
                    r.close()
            except (OSError, struct.error):
                pass  # corrupt/truncated cache: recompute
        elif cache_path:
            try:
                self._writer = FlowCacheWriter(cache_path, width, height,
                                               flow_type)
            except OSError:
                self._writer = None  # unwritable location: just recompute

    def _wrap(self, fwd: np.ndarray | None,
              bwd: np.ndarray | None) -> np.ndarray | FlowPair | None:
        if self.flow_type == FLOW_BACKWARD:
            return bwd
        return FlowPair(fwd, bwd)

    def _read_cached(self) -> FlowField | FlowPair | None:
        fwd = (self._reader.read()
               if self.flow_type in (FLOW_FORWARD, FLOW_BOTH) else None)
        bwd = (self._reader.read()
               if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH) else None)
        return self._wrap(None if fwd is None else FlowField(host=fwd),
                          None if bwd is None else FlowField(host=bwd))

    def _write_cached(self, fwd, bwd):
        if self._writer is None:
            return
        if self.flow_type in (FLOW_FORWARD, FLOW_BOTH):
            self._writer.write(fwd)
        if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH):
            self._writer.write(bwd)

    def compute(self, frame_bgr_u8: np.ndarray,
                frame_index: int) -> np.ndarray | FlowPair | None:
        """Flow for this frame (None for the first)."""
        if self._reader is not None:
            if frame_index == 0:
                return None
            return self._read_cached()
        gray = bgr_to_gray(frame_bgr_u8)
        flow = None
        if self._prev_gray is not None:
            cur = jnp.asarray(gray)
            prev = jnp.asarray(self._prev_gray)
            fwd = bwd = None
            if self.flow_type in (FLOW_FORWARD, FLOW_BOTH):
                fwd = FlowField(dev=tvl1_flow(prev, cur, self.params))
            if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH):
                bwd = FlowField(dev=tvl1_flow(cur, prev, self.params))
            self._write_cached(fwd, bwd)
            flow = self._wrap(fwd, bwd)
        self._prev_gray = gray
        return flow

    # -- micro-batched path -------------------------------------------------

    def push(self, frame_bgr_u8: np.ndarray,
             frame_index: int) -> list[tuple[int, np.ndarray,
                                             np.ndarray | None]]:
        """Buffer a frame; return completed (idx, frame, flow) triples."""
        if self._reader is not None:
            fl = None if frame_index == 0 else self._read_cached()
            return [(frame_index, frame_bgr_u8, fl)]
        self._pending.append((frame_index, frame_bgr_u8,
                              bgr_to_gray(frame_bgr_u8)))
        # The first frame of the stream has no backward flow: release it
        # immediately so downstream chunking is not skewed.
        out = []
        if frame_index == 0:
            idx, frame, gray = self._pending.pop(0)
            self._prev_gray = gray
            out.append((idx, frame, None))
        if len(self._pending) >= self.batch:
            out.extend(self._drain(pad_to_batch=True))
        return out

    def flush(self) -> list[tuple[int, np.ndarray, np.ndarray | None]]:
        """Compute flow for all remaining buffered frames."""
        return self._drain(pad_to_batch=bool(self._pending))

    def _drain(self, pad_to_batch: bool):
        if not self._pending:
            return []
        grays = [g for _, _, g in self._pending]
        prevs = ([self._prev_gray] if self._prev_gray is not None
                 else [grays[0]]) + grays[:-1]
        n_real = len(grays)
        # Pad to the canonical batch shape so the device program compiles
        # once; padded pairs repeat the last pair and are discarded.
        n_pad = self.batch - n_real if pad_to_batch else 0
        prevs_a = jnp.asarray(np.stack(prevs + [prevs[-1]] * n_pad))
        curs_a = jnp.asarray(np.stack(grays + [grays[-1]] * n_pad))

        def fields(dev_batch):
            """Per-frame FlowField handles over one batched device result;
            the batch stays on device — host copies download lazily, f16,
            one transfer for the whole batch (see _LazyFlowBatch)."""
            lazy = _LazyFlowBatch(dev_batch)
            return [FlowField(dev=dev_batch[i], batch=lazy, idx=i)
                    for i in range(n_real)]

        fwds = bwds = [None] * n_real
        if self.flow_type in (FLOW_BACKWARD, FLOW_BOTH):
            bwds = fields(tvl1_flow_batch(curs_a, prevs_a, self.params))
        if self.flow_type in (FLOW_FORWARD, FLOW_BOTH):
            fwds = fields(tvl1_flow_batch(prevs_a, curs_a, self.params))
        out = []
        for (idx, frame, gray), fw, bw in zip(self._pending, fwds, bwds):
            self._write_cached(fw, bw)
            out.append((idx, frame, self._wrap(fw, bw)))
        self._prev_gray = grays[-1]
        self._pending.clear()
        return out

    def close(self):
        if self._reader:
            self._reader.close()
        if self._writer:
            self._writer.close()
