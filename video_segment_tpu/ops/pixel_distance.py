"""Pixel/descriptor distance functions and aggregators.

Device-side counterparts of the reference's pixel_distance policy classes:

- ColorDiff3L1 / ColorDiff3L2 (pixel_distance.h:141-157): mean-normalized
  L1/L2 over 3 color channels.
- GradientDiffL1 / GradientDiffL2 (pixel_distance.h:160-175): 2-channel
  gradient difference; the L2 form is scaled by 10 and clamped to 1.
- GradientMeanDescriptorTraits (pixel_distance.h:523-561): region
  descriptor = sign-normalized gradient mean (InitializeDescriptor flips
  the sign so the first component is non-negative), distance = the scaled
  L2 form, thresholds 0.1 / 0.15.
- Distance aggregators (pixel_distance.h:712-744): linear (convex
  combination), independent (1 - (1-d1)(1-d2)), sqrt
  (sqrt(d1^2 + d2^2)/sqrt(2)) — applied to both pixel distances and
  descriptor distances/thresholds (AggregatedDescriptorTraits,
  pixel_distance.h:755-821).
"""

from __future__ import annotations

import jax.numpy as jnp

# BT.601 luminance weights for BGR input (the conversion the reference's
# LuminanceUnit applies, conversion_units.cpp).
_LUM_B, _LUM_G, _LUM_R = 0.114, 0.587, 0.299


def color_distance(a, b, metric: str = "l2"):
    """ColorDiff3L1/L2 over (..., 3) features."""
    d = a - b
    if metric == "l1":
        return jnp.sum(jnp.abs(d), axis=-1) * (1.0 / 3.0)
    return jnp.sqrt(jnp.sum(d * d, axis=-1) * (1.0 / 3.0))


def gradient_distance(a, b, metric: str = "l2"):
    """GradientDiffL1/L2 over (..., 2) gradient features."""
    d = a - b
    if metric == "l1":
        return jnp.sum(jnp.abs(d), axis=-1) * 0.5
    return jnp.minimum(1.0, 10.0 * jnp.sqrt(
        jnp.sum(d * d, axis=-1) * 0.5))


def aggregate(d1, d2, aggregator: str, weight1: float = 0.5):
    """Combine two distances (pixel_distance.h:712-744)."""
    if aggregator == "linear":
        return weight1 * d1 + (1.0 - weight1) * d2
    if aggregator == "independent":
        return 1.0 - (1.0 - d1) * (1.0 - d2)
    if aggregator == "sqrt":
        return jnp.sqrt(d1 * d1 + d2 * d2) * 0.70711
    raise ValueError(f"unknown aggregator {aggregator!r}")


def aggregate_scalar(d1: float, d2: float, aggregator: str,
                     weight1: float = 0.5) -> float:
    """Python-scalar aggregate (for static threshold combination,
    AggregatedDescriptorTraits::MergeDistanceThreshold)."""
    if aggregator == "linear":
        return weight1 * d1 + (1.0 - weight1) * d2
    if aggregator == "independent":
        return 1.0 - (1.0 - d1) * (1.0 - d2)
    if aggregator == "sqrt":
        return float((d1 * d1 + d2 * d2) ** 0.5 * 0.70711)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def gradient_features(vol):
    """(T,H,W,3) BGR [0,1] -> (T,H,W,2) central-difference luminance
    gradient (dL/dx, dL/dy), the pixel feature GradientDiff* and the
    gradient-mean trait consume."""
    lum = (vol[..., 0] * _LUM_B + vol[..., 1] * _LUM_G
           + vol[..., 2] * _LUM_R)
    gx = jnp.zeros_like(lum)
    gx = gx.at[..., 1:-1].set(0.5 * (lum[..., 2:] - lum[..., :-2]))
    gy = jnp.zeros_like(lum)
    gy = gy.at[..., 1:-1, :].set(0.5 * (lum[..., 2:, :] - lum[..., :-2, :]))
    return jnp.stack([gx, gy], axis=-1)


def sign_normalize(grad):
    """GradientMeanDescriptorTraits::InitializeDescriptor: flip both
    components so the first is non-negative (orientation-invariant
    accumulation)."""
    sign = jnp.where(grad[..., :1] < 0, -1.0, 1.0)
    return grad * sign


def gradient_trait_distance(mean_a, mean_b):
    """GradientMeanDescriptorTraits::DescriptorDistance on (..., 2)
    sign-normalized gradient means."""
    d = mean_a - mean_b
    return jnp.minimum(1.0, 10.0 * jnp.sqrt(jnp.sum(d * d, axis=-1) * 0.5))


GRADIENT_MERGE_THRESHOLD = 0.1   # pixel_distance.h:525
GRADIENT_SPLIT_THRESHOLD = 0.15  # pixel_distance.h:526
