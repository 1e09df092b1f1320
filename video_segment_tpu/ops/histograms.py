"""Region descriptor histograms and distances (device-side).

Device formulation of the reference's descriptor framework
(segmentation/region_descriptor.{h,cpp}, segmentation/histograms.{h,cpp}):
sparse per-region hash histograms become dense (R, bins) tables filled with
batched scatter-adds over whole frames; pairwise descriptor distances become
batched gathers + reductions over region-graph edge lists.

Formulas (reference):
- Lab color histogram: lum_bins x color_bins x color_bins over uint8-range
  Lab, bin = (L*lum>>8, a*cb>>8, b*cb>>8) (histograms.h:211-213); chi^2 =
  0.5 * sum (p-q)^2/(p+q) over L1-normalized histograms
  (histograms.cpp:396-407).
- Flow histograms: per-frame angle histogram, bin = floor(norm_angle * B)
  with norm_angle = atan2(y,x)/(2pi+1e-4)+0.5, weight = |v|
  (histograms.cpp:471-479); region distance = chi^2 per overlapping frame,
  weighted by min vector count (region_descriptor.cpp:465-498).
- Combined distance: SquaredOR (1-prod(1-d_i))^2 scaled by the region size
  penalizer min(1, 1 + p*log2(min_size/median_size)), clamped to [0,1]
  (region_descriptor.h:195-230, region_descriptor.cpp:377-383).

Color histograms are filled with trilinear interpolated adds on the
accumulation side (core/region.py `_accumulate_all`), matching the
reference's AddPixelInterpolated.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def lab_bins(lab_u8: jnp.ndarray, lum_bins: int = 10,
             color_bins: int = 20) -> jnp.ndarray:
    """(...,3) Lab in uint8 ranges -> flat bin index (histograms.h:211-213)."""
    l = (lab_u8[..., 0].astype(jnp.int32) * lum_bins) >> 8
    a = (lab_u8[..., 1].astype(jnp.int32) * color_bins) >> 8
    b = (lab_u8[..., 2].astype(jnp.int32) * color_bins) >> 8
    return (l * color_bins + a) * color_bins + b


def flow_bins(flow: jnp.ndarray, angle_bins: int = 16):
    """(...,2) flow -> (bin index, magnitude) (histograms.cpp:471-479)."""
    ang = jnp.arctan2(flow[..., 1], flow[..., 0]) / (2.0 * np.pi + 1e-4) + 0.5
    b = jnp.clip((ang * angle_bins).astype(jnp.int32), 0, angle_bins - 1)
    mag = jnp.hypot(flow[..., 0], flow[..., 1])
    return b, mag


@functools.partial(jax.jit, static_argnames=("num_regions", "num_bins"),
                   donate_argnums=(0,))
def accumulate_histogram(hist: jnp.ndarray, labels: jnp.ndarray,
                         bins: jnp.ndarray, weights: jnp.ndarray | None,
                         num_regions: int, num_bins: int) -> jnp.ndarray:
    """Scatter-add (label, bin[, weight]) samples into a (R, B) table."""
    key = labels.reshape(-1) * num_bins + bins.reshape(-1)
    w = (jnp.ones(key.shape, hist.dtype) if weights is None
         else weights.reshape(-1).astype(hist.dtype))
    flat = hist.reshape(-1).at[key].add(w)
    return flat.reshape(num_regions, num_bins)


def chi_square(a: jnp.ndarray, b: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """0.5 * sum (a-b)^2 / (a+b), zero-safe (histograms.cpp:396-407)."""
    add = a + b
    sub = a - b
    return 0.5 * jnp.sum(jnp.where(jnp.abs(add) > 1e-12, sub * sub, 0.0)
                         / jnp.where(jnp.abs(add) > 1e-12, add, 1.0),
                         axis=axis)


def normalize_l1(h: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    s = jnp.sum(h, axis=axis, keepdims=True)
    return h / jnp.maximum(s, 1e-20)


def edge_color_distance(hist: jnp.ndarray, edges: jnp.ndarray,
                        batch: int = 8192) -> jnp.ndarray:
    """chi^2 over normalized color hists for (E,2) region index pairs.

    Processes edges in batches to bound the gathered (batch, bins) windows.
    """
    e = edges.shape[0]
    pad = (-e) % batch
    ep = jnp.pad(edges, ((0, pad), (0, 0)))

    def body(chunk):
        ha = normalize_l1(hist[chunk[:, 0]])
        hb = normalize_l1(hist[chunk[:, 1]])
        return chi_square(ha, hb)

    out = jax.lax.map(body, ep.reshape(-1, batch, 2))
    return out.reshape(-1)[:e]


def edge_flow_distance(flow_hist: jnp.ndarray, flow_cnt: jnp.ndarray,
                       edges: jnp.ndarray, batch: int = 8192) -> jnp.ndarray:
    """Weighted per-frame chi^2 flow distance for (E,2) pairs.

    flow_hist: (T, R, B) per-frame magnitude-weighted angle histograms.
    flow_cnt: (T, R) vector counts (0 = region absent that frame).
    Weight per frame = min(count_a, count_b); frames where either side is
    absent contribute nothing (region_descriptor.cpp:465-498).
    """
    e = edges.shape[0]
    pad = (-e) % batch
    ep = jnp.pad(edges, ((0, pad), (0, 0)))
    fh = jnp.swapaxes(flow_hist, 0, 1)  # (R, T, B)
    fc = jnp.swapaxes(flow_cnt, 0, 1)   # (R, T)

    def body(chunk):
        ha = normalize_l1(fh[chunk[:, 0]])           # (b, T, B)
        hb = normalize_l1(fh[chunk[:, 1]])
        d = chi_square(ha, hb)                       # (b, T)
        wa = fc[chunk[:, 0]]
        wb = fc[chunk[:, 1]]
        w = jnp.minimum(wa, wb) * (wa > 0) * (wb > 0)
        ws = jnp.sum(w, axis=1)
        return jnp.where(ws > 0, jnp.sum(d * w, axis=1) / jnp.maximum(ws, 1.0),
                         0.0)

    out = jax.lax.map(body, ep.reshape(-1, batch, 2))
    return out.reshape(-1)[:e]


def edge_color_distance_windowed(whist: jnp.ndarray, wcnt: jnp.ndarray,
                                 edges: jnp.ndarray,
                                 batch: int = 4096) -> jnp.ndarray:
    """WindowedAppearanceDescriptor distance for (E,2) region pairs.

    whist: (NW, R, B) per-window gain-calibrated color histograms;
    wcnt:  (NW, R) sample counts (weight sums before normalization).
    Per window w of the lhs, the rhs is searched over w +/- 1 (the
    reference's compare_radius_ = 1) and the minimum chi^2 wins; window
    contributions are weighted by min(weight_lhs, weight_rhs) and averaged
    (region_descriptor.cpp:207-276).  Compare-time gain rescaling
    (ScaleHistogram when gain deviates >1.1x) is not re-applied; the
    accumulate-time calibration covers the common case.
    """
    e = edges.shape[0]
    nw = whist.shape[0]
    pad = (-e) % batch
    ep = jnp.pad(edges, ((0, pad), (0, 0)))
    wh = jnp.swapaxes(whist, 0, 1)   # (R, NW, B)
    wc = jnp.swapaxes(wcnt, 0, 1)    # (R, NW)

    def body(chunk):
        ha = normalize_l1(wh[chunk[:, 0]])           # (b, NW, B)
        hb = normalize_l1(wh[chunk[:, 1]])
        wa = wc[chunk[:, 0]]                         # (b, NW)
        wb = wc[chunk[:, 1]]
        dist_sum = jnp.zeros(chunk.shape[0], jnp.float32)
        weight_sum = jnp.zeros(chunk.shape[0], jnp.float32)
        for w in range(nw):
            best_d = jnp.full(chunk.shape[0], jnp.inf, jnp.float32)
            best_w = jnp.zeros(chunk.shape[0], jnp.float32)
            for m in range(max(w - 1, 0), min(w + 2, nw)):
                ok = (wa[:, w] > 0) & (wb[:, m] > 0)
                d = chi_square(ha[:, w], hb[:, m])
                wgt = jnp.minimum(wa[:, w], wb[:, m])
                take = ok & (d < best_d)
                best_d = jnp.where(take, d, best_d)
                best_w = jnp.where(take, wgt, best_w)
            valid = jnp.isfinite(best_d)
            dist_sum = dist_sum + jnp.where(valid, best_d * best_w, 0.0)
            weight_sum = weight_sum + jnp.where(valid, best_w, 0.0)
        return jnp.where(weight_sum > 0,
                         dist_sum / jnp.maximum(weight_sum, 1e-12), 0.0)

    out = jax.lax.map(body, ep.reshape(-1, batch, 2))
    return out.reshape(-1)[:e]


def combined_distance(color_d, flow_d, size_a, size_b, inv_median_size,
                      penalizer: float = 0.25, use_flow: bool = True):
    """SquaredORDistanceSizePenalized over [appearance, flow] + penalizer."""
    prod = (1.0 - color_d)
    if use_flow:
        prod = prod * (1.0 - flow_d)
    base = (1.0 - prod) ** 2
    min_sz = jnp.minimum(size_a, size_b)
    scale = jnp.minimum(
        1.0, 1.0 + penalizer * jnp.log2(
            jnp.maximum(min_sz * inv_median_size, 1e-20)))
    return jnp.clip(base * scale, 0.0, 1.0)
