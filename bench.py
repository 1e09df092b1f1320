"""Benchmark: full hierarchical segmentation throughput (frames/sec).

Runs the flagship pipeline (presmooth -> dense over-segmentation ->
hierarchical region segmentation -> .pb emission) on a seeded synthetic
clip (dataio.synthetic, --seed) and reports steady-state frames/sec on
the GPU.  Without a GPU it exits non-zero and measures nothing.

Prints the device (JAX platform, kind, count; the card's name and power
limit) on its own lines, then exactly one JSON line:
  {"metric": ..., "value": N, "unit": "fps", "device": {...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def run_pipeline(frames, width, height, use_flow=False,
                 over_segment_only=False, out_path=None):
    """Threaded stage chain (flow | dense | region | emit), matching
    seg_tree --use_pipeline: host RLE/proto work overlaps device solves.
    With `out_path`, the stream is written through SegmentationWriter to a
    real file (the full --write_to_file contract, chunked container
    included)."""
    from video_segment_tpu.core import dense, region
    from video_segment_tpu.core.options import (DenseSegmentationOptions,
                                                RegionSegmentationOptions)
    from video_segment_tpu.dataio import emit, seg_io
    from video_segment_tpu.runtime import pipeline as pl

    ds = dense.DenseSegmentation(DenseSegmentationOptions(async_tail=True),
                                 width, height)
    rs = (_NullRegion() if over_segment_only
          else region.RegionSegmentation(RegionSegmentationOptions(
              use_flow=use_flow), width, height))
    flow_eng = None
    if use_flow:
        from video_segment_tpu.core import flow as flow_mod
        flow_eng = flow_mod.FlowEngine(width, height)

    def _emit_flow(ready):
        out = []
        for idx, frame, fl in ready:
            rs.add_frame(idx, frame, fl)
            out.append((frame, fl))
        return out

    def flow_stage(item):
        idx, frame = item
        if flow_eng is None:
            return _emit_flow([(idx, frame, None)])
        return _emit_flow(flow_eng.push(frame, idx))

    def flow_flush():
        return _emit_flow(flow_eng.flush()) if flow_eng is not None else []

    stages = [pl.Stage("flow", flow_stage, flush=flow_flush),
              pl.Stage("dense", lambda pair: ds.process_frame(False, *pair),
                       flush=lambda: ds.process_frame(True)),
              pl.Stage("region", lambda sf: rs.process_frames(False, [sf]),
                       flush=lambda: rs.process_frames(True, []))]
    pipe = pl.Pipeline(stages, queue_size=10)

    writer = None
    if out_path:
        writer = seg_io.SegmentationWriter(out_path)
        assert writer.open_file(header_flags=[0, 1])
    payload_bytes = 0
    n_out = 0
    for sf in pipe.run(enumerate(frames)):
        payload = emit.segframe_to_bytes(sf)
        payload_bytes += len(payload)
        if writer is not None:
            writer.add_to_chunk(payload, pts=sf.frame_index * 100)
            if sf.hierarchy is not None and n_out > 0:
                writer.write_chunk()
        n_out += 1
    if writer is not None:
        writer.write_term_and_close()
    return n_out, payload_bytes


def run_fused(frames, width, height, n_clips, pbs):
    """Config-5 fused path: one vmapped dense solve per chunk index across
    clips (core.batch, banded-capable), per-clip region stages + writers —
    the device-side fusion of what the concurrent path interleaves."""
    from video_segment_tpu.core import region
    from video_segment_tpu.core.batch import BatchDenseSegmentation
    from video_segment_tpu.core.options import (DenseSegmentationOptions,
                                                RegionSegmentationOptions)
    from video_segment_tpu.dataio import emit, seg_io

    bd = BatchDenseSegmentation(DenseSegmentationOptions(async_tail=True),
                                width, height, n_clips)
    regs = [region.RegionSegmentation(RegionSegmentationOptions(
        use_flow=False), width, height) for _ in range(n_clips)]
    writers = []
    for pb in pbs:
        writers.append(seg_io.SegmentationWriter(pb))
        assert writers[-1].open_file(header_flags=[0, 1])
    n_out = [0] * n_clips
    total = 0

    def consume(i, sfs, flush):
        nonlocal total
        for sf in regs[i].process_frames(flush, sfs):
            if sf.hierarchy is not None and n_out[i] > 0:
                writers[i].write_chunk()
            writers[i].add_to_chunk(emit.segframe_to_bytes(sf),
                                    pts=sf.frame_index * 100)
            n_out[i] += 1
            total += 1

    for step, fr in enumerate(frames):
        for i in range(n_clips):
            regs[i].add_frame(step, fr, None)
        for i, sfs in enumerate(bd.process_frames(False, [fr] * n_clips)):
            consume(i, sfs, False)
    for i, sfs in enumerate(bd.process_frames(True)):
        consume(i, sfs, True)
        writers[i].write_chunk()
        writers[i].write_term_and_close()
    return total


class _NullRegion:
    """Over-segmentation-only stand-in (BASELINE config 1)."""

    def add_frame(self, *a, **kw):
        pass

    def process_frames(self, flush, seg_frames):
        return seg_frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic input clip")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX finds no GPU (default platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    print(f"device: {json.dumps(device)}")
    print(f"card: {card.strip()}")

    # BENCH_CONFIG selects a BASELINE.json config:
    #   1 over-seg only (272x480, flow off)
    #   2 full hierarchical (272x480, flow off)   [default; headline]
    #   3 flow-enabled 480p (480x854)
    #   4 streaming 720p (720x1280, bounded memory chunking)
    #   5 1080p two-clip batch (1080x1920)
    cfg = int(os.environ.get("BENCH_CONFIG", "2"))
    n_frames = int(os.environ.get("BENCH_FRAMES",
                                  "40" if cfg >= 4 else "60"))
    use_flow = os.environ.get("BENCH_FLOW", "1" if cfg == 3 else "0") == "1"
    h, w = {3: (480, 854), 4: (720, 1280),
            5: (1080, 1920)}.get(cfg, (480, 272))
    n_clips = 2 if cfg == 5 else 1

    from video_segment_tpu.dataio.synthetic import synthetic_clip

    frames = list(synthetic_clip(w, h, n_frames, args.seed))
    tmp = tempfile.TemporaryDirectory()

    # Warmup pass compiles all programs over the exact same shape sequence
    # (persistent cache makes this cheap on subsequent runs); the measured
    # passes then reflect steady-state throughput, reported as the best of
    # BENCH_REPEATS passes (default 2).
    run_pipeline(frames, w, h, use_flow, over_segment_only=cfg == 1)

    def one_pass():
        t0 = time.time()
        n_out = 0
        if n_clips > 1:
            # Batch mode (BASELINE config 5, + the segment_renderer leg at
            # render_level=0.1 inside the timed pass).  Two device paths:
            # BENCH_FUSED=1 -> core.batch fused vmapped multi-clip solve
            # (banded-capable since round 5); default -> clips interleaved
            # concurrently (device programs serialize; each clip's host
            # stages fill the other's device time).
            pbs = [os.path.join(tmp.name, f"bench_clip{i}.pb")
                   for i in range(n_clips)]
            if os.environ.get("BENCH_FUSED") == "1":
                n_out = run_fused(frames, w, h, n_clips, pbs)
            else:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=n_clips) as ex:
                    for n1, _ in ex.map(
                            lambda i: run_pipeline(frames, w, h, use_flow,
                                                   over_segment_only=cfg == 1,
                                                   out_path=pbs[i]),
                            range(n_clips)):
                        n_out += n1
            from video_segment_tpu.tools import renderer
            for i, pb in enumerate(pbs):
                rc = renderer.main(["-i", pb, "--render_level", "0.1",
                                    "--output_video",
                                    os.path.join(tmp.name,
                                                 f"bench_clip{i}_render.mp4")])
                assert rc in (0, None), f"renderer failed on {pb}"
        else:
            n_out, _ = run_pipeline(frames, w, h, use_flow,
                                    over_segment_only=cfg == 1,
                                    out_path=os.path.join(tmp.name,
                                                          "bench_out.pb"))
        dt = time.time() - t0
        return n_out, (n_out / dt if dt > 0 else 0.0)

    repeats = int(os.environ.get("BENCH_REPEATS", "2"))
    n_out, fps = 0, 0.0
    passes = []
    for _ in range(max(repeats, 1)):
        n1, f1 = one_pass()
        passes.append(round(f1, 3))
        if f1 > fps:
            n_out, fps = n1, f1

    tmp.cleanup()
    names = {1: "over-segmentation", 2: "full hierarchical segmentation",
             3: "flow-enabled segmentation", 4: "streaming 720p segmentation",
             5: "1080p two-clip batch segmentation"}
    print(json.dumps({
        "metric": f"{names[cfg]} fps ({w}x{h}, "
                  f"flow={'on' if use_flow else 'off'})",
        "value": round(fps, 3),
        "unit": "fps",
        "passes": passes,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
