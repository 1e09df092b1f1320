"""Tile pre-segmentation: label flooding inside (8,128) tiles.

Collapses obviously-mergeable pixels (color distance below the force-merge
weight — merges the reference performs unconditionally,
pixel_distance.h:487-491) into tile-local regions before the global solver
runs.  Labels min-flood over admissible in-tile N4 edges for a bounded
number of masked-shift iterations (one fused loop body over the whole
volume); edges that cross a tile border are never admissible, so the
flood stays inside its tile.

Output labels are global voxel indices of tile-local roots and feed the
solver's `init_label`; cross-tile merging remains the solver's job.
`tile_preseg_reference` is the independent NumPy oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from video_segment_tpu.ops import cc

TILE_H = 8
TILE_W = 128


def _dist(a, b, metric):
    d = a - b
    if metric == "l1":
        return (jnp.abs(d[..., 0]) + jnp.abs(d[..., 1])
                + jnp.abs(d[..., 2])) * (1.0 / 3.0)
    return jnp.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                     + d[..., 2] * d[..., 2]) * (1.0 / 3.0))


@functools.partial(jax.jit, static_argnames=("threshold", "metric", "iters"))
def tile_presegment(vol: jnp.ndarray, threshold: float = 0.002,
                    metric: str = "l2", iters: int = 48) -> jnp.ndarray:
    """(T,H,W,3) float volume -> (T,H,W) int32 labels (global voxel ids of
    tile-local roots).  Pixels whose in-tile N4 color distance is below
    `threshold` share a label; everything else keeps its own voxel id."""
    t, h, w, _ = vol.shape
    ys = jnp.arange(h)[None, :, None]
    xs = jnp.arange(w)[None, None, :]
    # Admissible in-tile N4 edges: `down` links (y,x)-(y+1,x), `right`
    # links (y,x)-(y,x+1); none crosses a tile border or the frame edge.
    down = ((_dist(vol, jnp.roll(vol, -1, axis=1), metric) <= threshold)
            & (ys % TILE_H < TILE_H - 1) & (ys + 1 < h))
    right = ((_dist(vol, jnp.roll(vol, -1, axis=2), metric) <= threshold)
             & (xs % TILE_W < TILE_W - 1) & (xs + 1 < w))
    # An edge seen from its lower/right end (rolls wrap only onto rows and
    # columns whose edges are masked off).
    up = jnp.roll(down, 1, axis=1)
    left = jnp.roll(right, 1, axis=2)

    def body(_, lab):
        lab = jnp.where(up, jnp.minimum(lab, jnp.roll(lab, 1, axis=1)), lab)
        lab = jnp.where(down, jnp.minimum(lab, jnp.roll(lab, -1, axis=1)),
                        lab)
        lab = jnp.where(left, jnp.minimum(lab, jnp.roll(lab, 1, axis=2)),
                        lab)
        return jnp.where(right, jnp.minimum(lab, jnp.roll(lab, -1, axis=2)),
                         lab)

    label0 = jnp.arange(t * h * w, dtype=jnp.int32).reshape(t, h, w)
    lab = jax.lax.fori_loop(0, iters, body, label0)
    # The bounded flood can leave label *chains* on regions whose
    # tile-local diameter exceeds `iters` (label[p] -> m, label[m] -> m' < m).
    # Consumers (notably _compact's is_root test) require fully resolved
    # labels, so collapse chains with pointer jumping; they are strictly
    # decreasing, hence acyclic, and almost always short (the while_loop
    # exits as soon as labels stabilize).
    return cc.pointer_jump(lab.reshape(-1)).reshape(lab.shape)


def tile_preseg_reference(vol: np.ndarray, threshold: float,
                          metric: str = "l2") -> np.ndarray:
    """NumPy oracle: per-tile N4 connected components under the distance
    threshold (scipy's graph components), each labelled with the global
    voxel id of its smallest pixel."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    vol = np.asarray(vol, np.float32)
    t, h, w, _ = vol.shape
    n = t * h * w

    def dist(d):
        if metric == "l1":
            return np.abs(d).sum(-1) / np.float32(3.0)
        return np.sqrt((d * d).sum(-1) / np.float32(3.0))

    thr = np.float32(threshold)
    down = ((dist(vol[:, 1:] - vol[:, :-1]) <= thr)
            & (np.arange(h - 1) % TILE_H != TILE_H - 1)[None, :, None])
    right = ((dist(vol[:, :, 1:] - vol[:, :, :-1]) <= thr)
             & (np.arange(w - 1) % TILE_W != TILE_W - 1)[None, None, :])
    ids = np.arange(n).reshape(t, h, w)
    a = np.concatenate([ids[:, :-1][down], ids[:, :, :-1][right]])
    b = np.concatenate([ids[:, 1:][down], ids[:, :, 1:][right]])
    _, comp = connected_components(
        coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(n, n)),
        directed=False)
    root = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(root, comp, np.arange(n))
    return root[comp].reshape(t, h, w)
