"""Pre-smoothing filters (device-side).

Behavioral parity targets:
- Gaussian: cv::GaussianBlur(3x3, sigma=1.5), reflect-101 border
  (reference: dense_segmentation.cpp:190).
- Bilateral: circular window of radius floor(1.5*sigma_space), replicate
  border, spatial weight exp(-0.5*r^2/ss^2), joint color weight
  exp(-0.5*||dc||^2/sc^2) shared by all channels
  (reference: imagefilter/image_filter.cpp:184-277; defaults 3.0 / 0.25 from
  dense_segmentation.cpp:195).  The reference's 4K-entry exp LUT is replaced
  by the exact exponential (LUT was a CPU optimization; the VPU computes exp
  directly).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("ksize", "sigma"))
def gaussian_blur(img: jnp.ndarray, ksize: int = 3, sigma: float = 1.5) -> jnp.ndarray:
    """Separable Gaussian blur of (H,W,C) float image, reflect-101 border."""
    k = jnp.asarray(_gaussian_kernel_1d(ksize, sigma))
    r = ksize // 2
    pad = jnp.pad(img, ((r, r), (0, 0), (0, 0)), mode="reflect")
    out = sum(k[i] * pad[i : i + img.shape[0]] for i in range(ksize))
    pad = jnp.pad(out, ((0, 0), (r, r), (0, 0)), mode="reflect")
    out = sum(k[i] * pad[:, i : i + img.shape[1]] for i in range(ksize))
    return out


def _circular_offsets(radius: int) -> list[tuple[int, int, float]]:
    offs = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 <= radius * radius:
                offs.append((dy, dx, float(r2)))
    return offs


@functools.partial(jax.jit, static_argnames=("sigma_space", "sigma_color"))
def bilateral_filter(img: jnp.ndarray, sigma_space: float = 3.0,
                     sigma_color: float = 0.25) -> jnp.ndarray:
    """Bilateral filter of an (H,W,C) float image.

    Full-window formulation: all taps unrolled into a stacked shift tensor so
    XLA fuses the weight computation (it is ~50 taps of elementwise work).
    """
    radius = int(sigma_space * 1.5)
    offs = _circular_offsets(radius)
    h, w, _ = img.shape
    # Planar (per-channel (H,W)) internals: a channels-minor (H,W,3) layout
    # puts 3 in the lane dimension and wastes 125/128 of every vector op.
    ch = [img[:, :, c] for c in range(3)]
    pads = [jnp.pad(c, radius, mode="edge") for c in ch]

    space_coeff = -0.5 / (sigma_space * sigma_space)
    color_coeff = -0.5 / (sigma_color * sigma_color)

    wsum = jnp.zeros((h, w), img.dtype)
    vsum = [jnp.zeros((h, w), img.dtype) for _ in range(3)]
    for dy, dx, r2 in offs:
        nb = [jax.lax.dynamic_slice(p, (dy + radius, dx + radius), (h, w))
              for p in pads]
        d2 = sum((c - n) ** 2 for c, n in zip(ch, nb))
        wt = np.exp(space_coeff * r2).astype(np.float32) * jnp.exp(color_coeff * d2)
        wsum = wsum + wt
        vsum = [v + wt * n for v, n in zip(vsum, nb)]
    den = jnp.maximum(wsum, 1e-20)
    return jnp.stack([v / den for v in vsum], axis=-1)


def presmooth(img: jnp.ndarray, mode: str = "bilateral") -> jnp.ndarray:
    """Reference presmoothing dispatch (dense_segmentation.cpp:183-198)."""
    if mode == "none":
        return img
    if mode == "gaussian":
        return gaussian_blur(img, 3, 1.5)
    if mode == "bilateral":
        return bilateral_filter(img, 3.0, 0.25)
    raise ValueError(f"unknown presmoothing mode: {mode}")
