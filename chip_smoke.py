#!/usr/bin/env python3
"""Smoke test of the segmentation system on NVIDIA GPUs.

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: the sharded path only

One process drives the card(s).  Without a GPU the script exits non-zero
before any phase.  Every phase prints its findings on lines of its own and
any failed check raises, so the script exits non-zero; nothing is caught.
Input clips come from the seeded generator (dataio.synthetic, --seed).

1. Tile pre-segmentation at 480x854 and 720x1280: the felz pre-solve
   against its NumPy mirror and the flood against its oracle, their
   steady-state time per frame, and the `gpu`-marked tests.
2. Flagship path: full hierarchical segmentation with flow at 480x854,
   60 frames, through api.segment_frames, emit and SegmentationWriter;
   the .pb is read back and its invariants checked.
3. HD banded path: 1280x720, flow off, 40 frames (row bands forced by
   max_solve_voxels), the same invariants, and the memory analysis of
   one compiled chunk solve.
4. GPU against CPU: the first chunk of phase 2's clip, cropped to
   272x480, over-segmented on the GPU (twice) and on the CPU device.

--four-cards runs only the mesh-sharded dense driver on a 720p clip
against the single-device banded solve, and the row-sharded
agglomeration against the unsharded one.

The last line of output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Share of pixels on which two label volumes that should be equal must
# agree when only the float summation order differs between them (the
# GPU's reductions against the NumPy mirror's): a flipped merge test
# changes the labels of a few regions, never a whole tile grid.
PARTITION_AGREEMENT = 0.999
# Fin levels trigger exactly at the merge threshold, so the mirror's
# float64 region means legitimately flip borderline tests; the floor is
# tests/test_tile_felz.py::test_kernel_matches_mirror's.
FIN_AGREEMENT = 0.97
# Boundary F between the GPU's and the CPU's level-0 over-segmentation of
# the same chunk (phase 4).  The solver's float segment sums run in
# another order on each device, which flips a few borderline merge tests;
# the first run on the card (H100 80GB HBM3, 400 W) measured 0.99968, and
# the floor leaves room for a few more flips, not for a changed algorithm.
GPU_CPU_BOUNDARY_F = 0.99


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def environment_lines() -> list[str]:
    import jax
    import jaxlib

    from video_segment_tpu import native

    lines = [f"jax {jax.__version__} jaxlib {jaxlib.__version__}",
             f"native library built and loaded: {native.available()} "
             f"({os.path.relpath(native.lib_path(), ROOT)})"]
    have_pb = (importlib.util.find_spec("google") is not None
               and importlib.util.find_spec("google.protobuf") is not None)
    lines.append(
        f"optional host packages (not used by these phases): "
        f"cv2={importlib.util.find_spec('cv2') is not None} "
        f"google.protobuf={have_pb} "
        f"protoc={shutil.which('protoc') is not None}")
    return lines


def _steady_time(fn, repeats: int = 5) -> float:
    """Median seconds of `fn()` (already compiled), blocking on results."""
    import jax

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_kernels(sizes=((480, 854), (720, 1280)), seed: int = 0) -> dict:
    """Felz and flood pre-segmentation on the device against their NumPy
    references at the given (height, width) frame sizes."""
    import jax

    from video_segment_tpu.core.dense import DenseSegmentation
    from video_segment_tpu.core.options import DenseSegmentationOptions
    from video_segment_tpu.dataio.synthetic import synthetic_clip
    from video_segment_tpu.ops import tile_felz, tile_preseg

    found = {}
    for h, w in sizes:
        frame = synthetic_clip(w, h, 1, seed)[0]
        ds = DenseSegmentation(DenseSegmentationOptions(), w, h)
        img = ds.preprocess(frame)
        p = ds._params
        preseg = functools.partial(ds._preseg_frame, img)
        lab, fin, stats = jax.block_until_ready(preseg())
        t_felz = _steady_time(preseg)
        vol = np.asarray(img)[None]
        lab_m, fin_m, stats_m = tile_felz.tile_felz_reference(
            vol, schedule=p.preseg_schedule,
            rounds_per_level=p.preseg_rounds_per_level,
            merge_threshold=p.merge_threshold, metric=p.metric,
            fin_margin=p.preseg_fin_margin, fin_eager=p.preseg_fin_eager,
            fin_gated=p.preseg_fin_gated, pair_merge=p.preseg_pair_merge)
        lab = np.asarray(lab)
        agree = float((lab == lab_m).mean())
        fin_agree = float((np.asarray(fin) == fin_m).mean())
        # Stats compare on the tiles whose labels agree exactly.
        ty = np.arange(lab.shape[1])[:, None] // tile_felz.TILE_H
        tx = np.arange(lab.shape[2])[None, :] // tile_felz.TILE_W
        tile = ty * (lab.shape[2] // tile_felz.TILE_W + 1) + tx
        bad = np.unique(tile[(lab != lab_m)[0]])
        keep = ~np.isin(tile, bad)
        size_ok = np.array_equal(np.asarray(stats[0])[0][keep],
                                 stats_m[0][0][keep])
        csum_err = max(float(np.max(
            np.abs(np.asarray(d)[0][keep] - m[0][keep])
            / np.maximum(np.abs(m[0][keep]), 1.0)))
            for d, m in zip(stats[1:], stats_m[1:]))
        say("phase1", f"felz {h}x{w}: labels equal on {agree:.6f} of "
            f"pixels ({len(np.unique(lab))} regions), fin levels on "
            f"{fin_agree:.6f}, sizes equal {size_ok}, color sums max "
            f"relative error {csum_err:.2e}; {t_felz * 1e3:.3f} ms/frame")
        check(agree >= PARTITION_AGREEMENT,
              f"felz labels agree on {agree} < {PARTITION_AGREEMENT}")
        check(fin_agree >= FIN_AGREEMENT,
              f"felz fin levels agree on {fin_agree} < {FIN_AGREEMENT}")
        check(size_ok, "felz region sizes differ from the mirror")
        check(csum_err <= 1e-5, f"felz color sums off by {csum_err}")

        thr = p.preseg_threshold
        full = tile_preseg.TILE_H * tile_preseg.TILE_W
        flood = jax.block_until_ready(
            tile_preseg.tile_presegment(img[None], thr, p.metric, full))
        want = tile_preseg.tile_preseg_reference(vol, thr, p.metric)
        f_agree = float((np.asarray(flood) == want).mean())
        default = functools.partial(tile_preseg.tile_presegment, img[None],
                                    thr, p.metric)
        jax.block_until_ready(default())
        t_flood = _steady_time(default)
        say("phase1", f"flood {h}x{w}: labels equal to the oracle on "
            f"{f_agree:.6f} of pixels; {t_flood * 1e3:.3f} ms/frame "
            f"(48 iterations)")
        check(f_agree >= PARTITION_AGREEMENT,
              f"flood labels agree on {f_agree} < {PARTITION_AGREEMENT}")
        found[(h, w)] = dict(felz_agree=agree, fin_agree=fin_agree,
                             felz_ms=t_felz * 1e3, flood_agree=f_agree,
                             flood_ms=t_flood * 1e3)
    return found


def run_gpu_tests() -> None:
    """The `gpu`-marked tests (tests/test_gpu.py: the other test modules
    may need the optional host packages), in this process, on the card."""
    import pytest

    os.environ["VST_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    say("phase1", f"gpu-marked tests: pytest exit code {int(rc)}")
    check(int(rc) == 0, f"gpu-marked tests failed (pytest rc {int(rc)})")


def _segment_to_pb(clip, path: str, use_flow: bool, dense_options) -> int:
    """The library entry point end to end: api.segment_frames, emit, and
    the chunked container, as a user writes a stream."""
    from video_segment_tpu import api
    from video_segment_tpu.dataio import emit, seg_io

    _, h, w, _ = clip.shape
    writer = seg_io.SegmentationWriter(path)
    check(writer.open_file(header_flags=[0, 1]), f"cannot open {path}")
    n = 0
    for sf in api.segment_frames(iter(clip), w, h, use_flow=use_flow,
                                 dense_options=dense_options):
        if sf.hierarchy is not None and n > 0:
            writer.write_chunk()
        writer.add_to_chunk(emit.segframe_to_bytes(sf),
                            pts=sf.frame_index * 100)
        n += 1
    writer.write_term_and_close()
    return n


def check_pb(path: str, width: int, height: int, frames: int,
             phase: str) -> dict:
    """Read a written stream back (protobuf-free decoder) and check its
    invariants: all frames present in order, every pixel labelled once,
    region ids sorted, hierarchy only on chunk-start frames."""
    from video_segment_tpu.dataio import fast_proto, seg_io

    reader = seg_io.SegmentationReader(path)
    check(reader.open_and_read_headers(), f"cannot read {path}")
    descs = [fast_proto.decode_frame(p) for p in reader]
    reader.close()
    check(len(descs) == frames, f"{len(descs)} frames, want {frames}")
    regions, levels, starts = [], 0, 0
    for i, d in enumerate(descs):
        check((d["frame_width"], d["frame_height"]) == (width, height),
              f"frame {i}: wrong size")
        ids = d["region_ids"]
        check(bool(np.all(np.diff(ids) > 0)), f"frame {i}: ids not sorted")
        iv = d["intervals"]
        cover = np.zeros(height * width, np.int32)
        ln = iv[:, 2] - iv[:, 1] + 1
        starts_px = iv[:, 0] * width + iv[:, 1]
        idx = np.repeat(starts_px - np.concatenate(([0], np.cumsum(ln)[:-1])),
                        ln) + np.arange(ln.sum())
        np.add.at(cover, idx, 1)
        check(bool(np.all(cover == 1)),
              f"frame {i}: {int((cover != 1).sum())} pixels not labelled "
              f"exactly once")
        has_h = len(d["hierarchy"]) > 0
        check(has_h == (d["hierarchy_frame_idx"] == i),
              f"frame {i}: hierarchy on a frame that does not start its "
              f"chunk (hierarchy_frame_idx {d['hierarchy_frame_idx']})")
        if has_h:
            starts += 1
            levels = max(levels, len(d["hierarchy"]))
        regions.append(len(ids))
    say(phase, f"stream checks passed: {frames} frames, every pixel "
        f"labelled once, ids sorted, hierarchy on {starts} chunk-start "
        f"frames only (up to {levels} levels), "
        f"{int(np.mean(regions))} regions/frame on average")
    return dict(frames=frames, chunk_starts=starts, levels=levels)


def _peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not reported by this device"
    return f"{stats['peak_bytes_in_use']} bytes"


def phase_main(width: int = 854, height: int = 480, frames: int = 60,
               seed: int = 0, use_flow: bool = True, phase: str = "phase2",
               dense_options=None) -> dict:
    """Full hierarchical segmentation of a synthetic clip, twice: the
    first pass includes compilation, the second runs warm."""
    from video_segment_tpu.dataio.synthetic import synthetic_clip

    clip = synthetic_clip(width, height, frames, seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.pb")
        t0 = time.perf_counter()
        n = _segment_to_pb(clip, path, use_flow, dense_options)
        first = time.perf_counter() - t0
        found = check_pb(path, width, height, frames, phase)
        t0 = time.perf_counter()
        n_warm = _segment_to_pb(clip, path, use_flow, dense_options)
        warm = time.perf_counter() - t0
    check(n == n_warm == frames, f"{n} / {n_warm} frames, want {frames}")
    say(phase, f"{width}x{height} x{frames} flow={use_flow}: first pass "
        f"{first:.3f} s (compilation included), warm pass {warm:.3f} s = "
        f"{frames / warm:.3f} fps, compile share ~{first - warm:.3f} s, "
        f"peak device memory {_peak_bytes()}")
    found.update(first_s=first, warm_s=warm, fps=frames / warm)
    return found


def chunk_memory_analysis(width: int, height: int, seed: int = 0,
                          opts=None):
    """Compile the first (free) chunk solve of a DenseSegmentation at this
    size and return (bands, compiled.memory_analysis())."""
    import jax

    from video_segment_tpu.core import oversegmentation as ov
    from video_segment_tpu.core.dense import DenseSegmentation
    from video_segment_tpu.core.options import DenseSegmentationOptions
    from video_segment_tpu.dataio.synthetic import synthetic_clip

    opts = opts or DenseSegmentationOptions()
    ds = DenseSegmentation(opts, width, height)
    for frame in synthetic_clip(width, height, opts.chunk_size, seed):
        ds._ingest(frame, None)
    prep = ds._prepare_chunk(False)

    def solve(vol, init_label, fin, cells):
        return ov.oversegment(vol, init_label=init_label, fin=fin,
                              params=prep["params"], cell_stats=cells,
                              head_planes=prep["head_planes"])

    compiled = jax.jit(solve).lower(
        prep["vol"], prep["init_label"], prep["tile_fin"],
        prep["tile_stats"]).compile()
    return ds._bands, compiled.memory_analysis()


def phase_banded(width: int = 1280, height: int = 720, frames: int = 40,
                 seed: int = 0, max_solve_voxels: int | None = None) -> dict:
    """The flagship path without flow at a size whose chunk solves split
    into row bands (`max_solve_voxels` overrides the library default)."""
    from video_segment_tpu.core.options import DenseSegmentationOptions

    opts = DenseSegmentationOptions()
    if max_solve_voxels:
        opts.max_solve_voxels = max_solve_voxels
    found = phase_main(width, height, frames, seed, use_flow=False,
                       phase="phase3", dense_options=opts)
    bands, mem = chunk_memory_analysis(width, height, seed, opts)
    check(bands > 1, f"{width}x{height} solved in {bands} band(s); the "
          f"banded path did not run")
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    desc = ", ".join(f"{f} {getattr(mem, f, 'n/a')}" for f in fields)
    say("phase3", f"chunk solve in {bands} row bands; memory analysis: "
        f"{desc}")
    found.update(bands=bands)
    return found


def _first_chunk_labels(clip) -> np.ndarray:
    """Global-id label volume of the first dense chunk of `clip`."""
    from video_segment_tpu.core.dense import DenseSegmentation
    from video_segment_tpu.core.options import DenseSegmentationOptions
    from video_segment_tpu.segment_util import util

    _, h, w, _ = clip.shape
    opts = DenseSegmentationOptions()
    ds = DenseSegmentation(opts, w, h)
    out = []
    for frame in clip[:opts.chunk_size]:
        out += ds.process_frame(False, frame)
    check(len(out) > 0, "the first chunk emitted no frames")
    return np.stack([util.rasterize_ids(f.region_ids, f.interval_counts,
                                        np.stack([f.ys, f.lxs, f.rxs], 1),
                                        h, w) for f in out])


def phase_gpu_vs_cpu(width: int = 854, height: int = 480, crop=(272, 480),
                     seed: int = 0) -> dict:
    """Level-0 over-segmentation of one chunk on the default device (twice)
    and on the CPU device of the same process."""
    import jax

    from video_segment_tpu.core.options import DenseSegmentationOptions
    from video_segment_tpu.dataio.synthetic import synthetic_clip
    from video_segment_tpu.segment_util.metrics import boundary_f_measure

    n = DenseSegmentationOptions().chunk_size
    clip = synthetic_clip(width, height, n, seed)[:, :crop[0], :crop[1]]
    dev_a = _first_chunk_labels(clip)
    dev_b = _first_chunk_labels(clip)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _first_chunk_labels(clip)
    repeat = bool(np.array_equal(dev_a, dev_b))
    f = boundary_f_measure(dev_a, cpu)["f_measure"]
    say("phase4", f"{crop[0]}x{crop[1]} x{len(dev_a)} frames: "
        f"{jax.devices()[0].platform} vs cpu boundary F {f:.6f}; two "
        f"{jax.devices()[0].platform} runs identical: {repeat}")
    check(f >= GPU_CPU_BOUNDARY_F,
          f"boundary F {f} < {GPU_CPU_BOUNDARY_F} between devices")
    return dict(boundary_f=f, repeatable=repeat)


def phase_four_cards(width: int = 1280, height: int = 720, frames: int = 40,
                     seed: int = 0, regions: int = 4000,
                     devices: int = 4) -> dict:
    """Mesh-sharded dense driver vs the single-device banded solve, and the
    row-sharded agglomeration vs the unsharded one, bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from video_segment_tpu.core import agglomeration
    from video_segment_tpu.core.dense import DenseSegmentation
    from video_segment_tpu.core.options import DenseSegmentationOptions
    from video_segment_tpu.dataio.synthetic import synthetic_clip
    from video_segment_tpu.parallel import mesh as pmesh
    from video_segment_tpu.segment_util import util

    mesh = pmesh.make_mesh(devices, data=1, space=devices)
    clip = synthetic_clip(width, height, frames, seed)

    def stream(use_mesh):
        opts = DenseSegmentationOptions(
            solver_bands=0 if use_mesh else devices)
        ds = DenseSegmentation(opts, width, height,
                               mesh=mesh if use_mesh else None)
        out = []
        t0 = time.perf_counter()
        for frame in clip:
            out += ds.process_frame(False, frame)
        out += ds.process_frame(True)
        dt = time.perf_counter() - t0
        check(ds._chunk_id >= 2, "the constrained chunk path did not run")
        return dt, [util.rasterize_ids(f.region_ids, f.interval_counts,
                                       np.stack([f.ys, f.lxs, f.rxs], 1),
                                       height, width) for f in out]

    t_single, single = stream(False)
    t_mesh, sharded = stream(True)
    check(len(single) == len(sharded) == frames,
          f"{len(single)} / {len(sharded)} frames, want {frames}")
    equal = all(np.array_equal(a, b) for a, b in zip(single, sharded))
    say("four", f"dense {width}x{height} x{frames}: {devices}-device mesh "
        f"(space={devices}) vs single-device {devices}-band solve: "
        f"bit-for-bit equal {equal} (first pass each, compilation "
        f"included: single {t_single:.3f} s, mesh {t_mesh:.3f} s)")
    check(equal, "mesh-sharded labels differ from the single-device solve")

    # Row-sharded agglomeration: regions on a grid, histograms peaked in a
    # random bin plus noise.
    rng = np.random.default_rng(seed)
    rcap = -(-regions // devices) * devices + devices
    nb = 4000
    hist = np.zeros((rcap, nb), np.float32)
    hist[np.arange(regions), rng.integers(0, nb, regions)] = 100.0
    hist[:regions] += rng.random((regions, nb)).astype(np.float32)
    sizes = np.zeros(rcap, np.float32)
    sizes[:regions] = rng.integers(50, 500, regions).astype(np.float32)
    side = int(np.ceil(np.sqrt(regions)))
    ids = np.arange(regions)
    right = ids[(ids % side < side - 1) & (ids + 1 < regions)]
    down = ids[ids + side < regions]
    edges = np.concatenate([np.stack([right, right + 1], 1),
                            np.stack([down, down + side], 1)])
    fh = np.zeros((0, rcap, 4), np.float32)
    fc = np.zeros((0, rcap), np.float32)
    plain = agglomeration.agglomerate(hist, fh, fc, sizes, edges, regions,
                                      use_flow=False)
    rows = NamedSharding(mesh, PartitionSpec(("data", "space"), None))
    flat = NamedSharding(mesh, PartitionSpec(("data", "space")))
    sharded_h = agglomeration.agglomerate(
        jax.device_put(jnp.asarray(hist), rows), fh, fc,
        jax.device_put(jnp.asarray(sizes), flat), edges, regions,
        use_flow=False)
    agg_equal = (len(plain) == len(sharded_h) > 0 and all(
        np.array_equal(a, b) for a, b in zip(plain, sharded_h)))
    say("four", f"agglomeration of {regions} regions x {nb} bins, rows "
        f"sharded over {devices} devices: {len(plain)} levels, equal to "
        f"the unsharded hierarchy {agg_equal}")
    check(agg_equal, "row-sharded agglomeration differs")
    return dict(dense_equal=equal, agglomeration_equal=agg_equal)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic input clips")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (default platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    for line in environment_lines():
        print(line, flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        check(len(devices) >= 4, f"--four-cards needs 4 GPUs, "
              f"found {len(devices)}")
        phase_four_cards(seed=args.seed)
    else:
        phase_kernels(seed=args.seed)
        run_gpu_tests()
        phase_main(seed=args.seed)
        phase_banded(seed=args.seed)
        phase_gpu_vs_cpu(seed=args.seed)
    print(f"all phases passed in {time.perf_counter() - t0:.3f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
