#!/usr/bin/env python
"""Generate golden reference output and score the JAX rebuild against it.

Steps:
  1. Decode frames of the input video with cv2 into /tmp PNGs (the harness
     driver has no FFmpeg).
  2. Run the reference pipeline (golden_driver, built by build.sh from the
     upstream sources) -> golden .pb.
  3. Run the JAX rebuild on the same frames -> our .pb.
  4. Probe BOTH files with the reference's own reader (pb_inspect):
     wire-compat + hierarchy verification.
  5. Score per-frame boundary F-measure between the two segmentations at
     matched hierarchy levels (0 = over-segmentation base of the region
     stage, plus fractional levels), using our metrics module.

Usage:
  python tools/ref_harness/make_golden.py [--video PATH] [--max-frames N]
      [--skip-ours] [--flow] [--levels 0,0.4,0.75]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

DEFAULT_VIDEO = "/root/reference/video_example/test_video.MOV"
BUILD = os.environ.get("REF_BUILD", "/tmp/refbuild")


def dump_frames(video: str, out_dir: str, max_frames: int) -> int:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and n >= max_frames):
            break
        cv2.imwrite(os.path.join(out_dir, f"frame_{n:06d}.png"), frame)
        n += 1
    cap.release()
    return n


def run(cmd: list[str], **kw) -> str:
    print("+", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, **kw)
    sys.stdout.write(proc.stdout[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed rc={proc.returncode}")
    return proc.stdout


def id_images_from_pb(path: str, levels: list[float]) -> dict[float, np.ndarray]:
    """Render (T,H,W) int32 id volumes at each fractional level."""
    from video_segment_tpu.dataio.seg_io import SegmentationReader
    from video_segment_tpu.proto import SegmentationDesc
    from video_segment_tpu.segment_util.util import (absolute_level,
                                                     desc_to_id_image)

    reader = SegmentationReader(path)
    assert reader.open_and_read_headers()
    frames = []
    hierarchy = None
    for payload in reader:
        desc = SegmentationDesc.FromString(payload)
        if len(desc.hierarchy) > 0:
            hierarchy = desc.hierarchy
        frames.append((desc, hierarchy))
    reader.close()

    out = {}
    for frac in levels:
        imgs = []
        for desc, hier in frames:
            level = absolute_level(hier, frac)
            imgs.append(desc_to_id_image(desc, hier, level))
        out[frac] = np.stack(imgs)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", default=DEFAULT_VIDEO)
    ap.add_argument("--max-frames", type=int, default=60)
    ap.add_argument("--skip-ours", action="store_true",
                    help="only regenerate the reference golden output")
    ap.add_argument("--skip-golden", action="store_true",
                    help="reuse existing golden .pb")
    ap.add_argument("--levels", default="0,0.4,0.75")
    ap.add_argument("--ours-args", default="",
                    help="extra seg_tree flags for the sweep harness, e.g. "
                         "'--solver_param preseg_fin_margin=1.5'")
    ap.add_argument("--out-json", default=os.path.join(BUILD, "fmeasure.json"))
    args = ap.parse_args()
    levels = [float(x) for x in args.levels.split(",")]

    frames_dir = os.path.join(BUILD, "frames")
    golden_pb = os.path.join(BUILD, "golden_ref.pb")
    ours_pb = os.path.join(BUILD, "ours.pb")

    n = dump_frames(args.video, frames_dir, args.max_frames)
    print(f"dumped {n} frames")

    if not args.skip_golden or not os.path.exists(golden_pb):
        t0 = time.time()
        run([os.path.join(BUILD, "golden_driver"),
             f"--frames_dir={frames_dir}", f"--output={golden_pb}"])
        golden_s = time.time() - t0
        print(f"golden reference run: {golden_s:.1f}s "
              f"({n / golden_s:.2f} fps)")

    run([os.path.join(BUILD, "pb_inspect"), f"--input={golden_pb}"])

    if not args.skip_ours:
        t0 = time.time()
        run([sys.executable, "-m", "video_segment_tpu.tools.seg_tree",
             "--input_file", args.video, "--trim_to", str(n),
             "--write_to_file", "--output_file", ours_pb, "--no-flow",
             # Score the solver's own rasters, not the vectorization
             # round-trip (the shipped write default strips rasters for
             # reference parity, seg_tree.cpp:308).
             "--keep_rasterization"]
            + args.ours_args.split(), cwd=REPO)
        ours_s = time.time() - t0
        print(f"our run: {ours_s:.1f}s ({n / ours_s:.2f} fps)")

        # Wire-compat proof: the reference's own reader consumes our file.
        run([os.path.join(BUILD, "pb_inspect"), f"--input={ours_pb}"])

        print("scoring boundary F-measure ...")
        from video_segment_tpu.segment_util.metrics import boundary_f_measure

        golden_ids = id_images_from_pb(golden_pb, levels)
        our_ids = id_images_from_pb(ours_pb, levels)
        results = {}
        for frac in levels:
            g, o = golden_ids[frac], our_ids[frac]
            t = min(len(g), len(o))
            m = boundary_f_measure(g[:t], o[:t])
            # Granularity diagnostic: mean regions/frame at this level for
            # both sides (the base-level count gap is the quality lever).
            m["regions_ref"] = round(float(np.mean(
                [len(np.unique(fr)) for fr in g[:t]])), 1)
            m["regions_ours"] = round(float(np.mean(
                [len(np.unique(fr)) for fr in o[:t]])), 1)
            results[str(frac)] = m
            print(f"level {frac}: F={m['f_measure']:.4f} "
                  f"P={m['precision']:.4f} R={m['recall']:.4f} "
                  f"n_ref={m['regions_ref']} n_ours={m['regions_ours']}")
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
        print("wrote", args.out_json)


if __name__ == "__main__":
    main()
