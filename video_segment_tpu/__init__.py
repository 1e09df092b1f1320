"""Hierarchical graph-based video segmentation framework.

A from-scratch JAX/XLA implementation of the capabilities of the
Grundmann et al. CVPR'10 streaming hierarchical video segmentation system:

- ``ops``: device kernels — color conversion, smoothing, spatio-temporal edge
  weights, data-parallel connected components, histograms, TV-L1 optical flow.
- ``core``: the segmentation engine — over-segmentation solver, streaming
  dense driver, hierarchical agglomeration, chunk-set streaming.
- ``dataio``: wire-compatible protobuf emission and the chunked ``.pb``
  container, video decode, flow caching, synthetic clips.
- ``segment_util``: host-side result utilities (hierarchies, rendering,
  boundaries, vectorization).
- ``parallel``: device-mesh sharding of the compute path.
- ``runtime``: the host streaming pipeline and telemetry.
"""

__version__ = "0.1.0"

import os as _os

# Persistent compilation cache: solver programs are large and their XLA
# compiles are expensive, so cache them across processes.  Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the package
# sets nothing; otherwise the cache lives at a fixed path in the checkout.
CACHE_DIR = _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", ".jax_cache"))


def _configure_jax():
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


_configure_jax()
