"""Package-level contracts: no Pallas, the compile cache location, and a
segmentation path that needs nothing beyond JAX, NumPy and SciPy."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    full.pop("JAX_COMPILATION_CACHE_DIR", None)
    full.update(env)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_package_imports_no_pallas():
    out = _run(
        "import sys\n"
        "import video_segment_tpu.api, video_segment_tpu.core.region\n"
        "import video_segment_tpu.core.batch\n"
        "import video_segment_tpu.parallel.mesh\n"
        "from video_segment_tpu.ops import tile_felz, tile_preseg\n"
        "print(sorted(m for m in sys.modules if 'pallas' in m))")
    assert out == "[]"


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    out = _run("import jax, video_segment_tpu\n"
               "print(jax.config.jax_compilation_cache_dir)",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out == str(tmp_path)


def test_cache_falls_back_to_checkout():
    out = _run("import jax, video_segment_tpu\n"
               "print(jax.config.jax_compilation_cache_dir)")
    assert out == os.path.join(ROOT, ".jax_cache")


def test_segmentation_runs_without_cv2_and_protobuf():
    """A tiny clip through the flagship path (flow, hierarchy, emit, the
    chunked container, read back) with `cv2` and `google` unimportable."""
    out = _run('''
import sys


class Block:
    # `google` itself may be a namespace package set up at start-up.
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "google"):
            raise ImportError("blocked " + name)


sys.meta_path.insert(0, Block())
import os, tempfile
import numpy as np
from video_segment_tpu import api
from video_segment_tpu.dataio import emit, fast_proto, seg_io
from video_segment_tpu.dataio.synthetic import synthetic_clip

clip = synthetic_clip(64, 48, 6, seed=0)
path = os.path.join(tempfile.mkdtemp(), "out.pb")
w = seg_io.SegmentationWriter(path)
assert w.open_file(header_flags=[0, 1])
for sf in api.segment_frames(iter(clip), 64, 48, use_flow=True):
    w.add_to_chunk(emit.segframe_to_bytes(sf), pts=sf.frame_index)
w.write_term_and_close()
r = seg_io.SegmentationReader(path)
assert r.open_and_read_headers()
frames = [fast_proto.decode_frame(p) for p in r]
assert len(frames) == 6 and len(frames[0]["hierarchy"]) >= 1
assert not [m for m in sys.modules
            if m.split(".")[0] == "cv2" or m.startswith("google.protobuf")]
print("ok")
''')
    assert out == "ok"
