"""Seeded synthetic video clips: textured patches under a global pan, one
independently moving object, and sensor noise.

Stands in for camera footage wherever the repository needs frames it can
rebuild anywhere (tests, `bench.py`, `chip_smoke.py`): the same seed,
size and length always give the same uint8 BGR frames.
"""

from __future__ import annotations

import numpy as np


def _patch_style(rng):
    """Base color and sinusoidal grating (orientation, period, amplitude)
    of one textured patch."""
    return (rng.uniform(20.0, 235.0, size=3).astype(np.float32),
            rng.uniform(0, np.pi), rng.uniform(6.0, 40.0),
            rng.uniform(0.0, 30.0))


def _paint_ellipse(img, cy, cx, ry, rx, style):
    """Paint a filled ellipse centred at (cy, cx) onto `img` (H,W,3)
    float32; its grating is fixed to the ellipse, so it moves with it."""
    h, w, _ = img.shape
    y0, y1 = max(0, int(cy - ry)), min(h, int(cy + ry) + 1)
    x0, x1 = max(0, int(cx - rx)), min(w, int(cx + rx) + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    yy -= cy
    xx -= cx
    inside = (yy / ry) ** 2 + (xx / rx) ** 2 <= 1.0
    base, theta, period, amp = style
    phase = (np.cos(theta) * xx + np.sin(theta) * yy) * (2 * np.pi / period)
    tex = base + (amp * np.sin(phase))[..., None]
    img[y0:y1, x0:x1][inside] = tex[inside]


def synthetic_clip(width: int, height: int, frames: int,
                   seed: int = 0) -> np.ndarray:
    """(frames, height, width, 3) uint8 BGR clip.

    A canvas of textured elliptical patches (painted over a smooth
    gradient) pans by (2, 1) pixels per frame; one textured object moves
    on its own straight path, bouncing off the frame edges; Gaussian noise
    of sigma 2 grey levels is added to every frame.
    """
    if width < 8 or height < 8 or frames < 1:
        raise ValueError(f"clip too small: {width}x{height}x{frames}")
    rng = np.random.default_rng(seed)
    vx, vy = 2, 1
    ch, cw = height + vy * frames, width + vx * frames
    gy, gx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    canvas = np.stack([60 + 100 * gy / ch, 80 + 60 * gx / cw,
                       120 + 40 * (gx + gy) / (cw + ch)], axis=-1)
    n_patches = max(8, ch * cw // 6000)
    scale = np.sqrt(ch * cw / n_patches)
    for _ in range(n_patches):
        _paint_ellipse(canvas, rng.uniform(0, ch), rng.uniform(0, cw),
                       rng.uniform(0.4, 1.2) * scale,
                       rng.uniform(0.4, 1.2) * scale, _patch_style(rng))

    obj_style = _patch_style(rng)
    ry, rx = max(3.0, height / 6), max(3.0, width / 8)
    py, px = rng.uniform(0, height), rng.uniform(0, width)
    sy, sx = rng.uniform(-4, 4), rng.uniform(-6, 6)

    out = np.empty((frames, height, width, 3), np.uint8)
    for t in range(frames):
        img = canvas[vy * t:vy * t + height, vx * t:vx * t + width].copy()
        _paint_ellipse(img, py, px, ry, rx, obj_style)
        img += rng.normal(0.0, 2.0, size=img.shape).astype(np.float32)
        out[t] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        py, px = py + sy, px + sx
        if not 0 <= py < height:
            sy, py = -sy, min(max(py, 0.0), height - 1.0)
        if not 0 <= px < width:
            sx, px = -sx, min(max(px, 0.0), width - 1.0)
    return out
