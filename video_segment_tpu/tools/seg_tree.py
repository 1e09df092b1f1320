"""Flagship CLI: full streaming segmentation of a video file.

JAX equivalent of the reference seg_tree_sample
(seg_tree_sample/seg_tree.cpp:52-369): decode -> (optical flow) -> dense
over-segmentation -> hierarchical region segmentation -> .pb / rendered
video outputs.  Flag names mirror the reference CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_arg_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_file", "-i", required=True,
                   help="input video file or CAMERA")
    p.add_argument("--flow", action=argparse.BooleanOptionalAction,
                   default=True, help="use dense optical flow")
    p.add_argument("--flow_type", choices=["backward", "forward", "both"],
                   default="backward",
                   help="flow direction(s) to compute (DenseFlowOptions."
                        "flow_type, flow_reader.h:145); segmentation "
                        "consumes the backward field")
    p.add_argument("--display_flow", action="store_true",
                   help="show HSV-rendered flow (hue=angle, sat/val="
                        "magnitude; flow_reader.cpp:306-330)")
    p.add_argument("--over_segment", action="store_true",
                   help="over-segmentation only (no hierarchy stage)")
    p.add_argument("--write_to_file", action="store_true",
                   help="write <input>.pb segmentation stream")
    p.add_argument("--keep_rasterization", action="store_true",
                   help="keep per-region RLE rasters in the written "
                        "stream; by default hierarchical output carries "
                        "vectorization only, as the reference writer does "
                        "(remove_rasterization=true, seg_tree.cpp:308) — "
                        "consumers rebuild rasters from the polygons")
    p.add_argument("--output_file", default="",
                   help="override .pb output path")
    p.add_argument("--render_and_save", action="store_true",
                   help="render region video(s) to mp4")
    p.add_argument("--display", type=float, default=-1,
                   help="render level in [0,1); negative disables; a "
                        "'level %%' trackbar adjusts it at runtime")
    p.add_argument("--blend_alpha", type=float, default=0.5,
                   help="display blend of rendered regions over the "
                        "source frame (video_display_qt_unit.h options)")
    p.add_argument("--trim_to", type=int, default=0,
                   help="process only the first N frames")
    p.add_argument("--downscale_min_size", type=int, default=0,
                   help="downscale so min dimension equals this")
    p.add_argument("--run_on_server", action="store_true",
                   help="server preset: downscale to 360, write output")
    p.add_argument("--chunk_size", type=int, default=20)
    p.add_argument("--save_flow", action="store_true",
                   help="cache computed flow to <input>.flow")
    p.add_argument("--use_pipeline", action=argparse.BooleanOptionalAction,
                   default=True, help="overlap host stages in threads")
    p.add_argument("--max_rate", type=float, default=20.0,
                   help="source fps cap in pipeline mode (RatePolicy."
                        "max_rate, seg_tree.cpp:345; 0 = unlimited)")
    p.add_argument("--dynamic_rate", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="adapt the source rate to the slowest stage and "
                        "throttle on queue depth (RatePolicy.dynamic_rate)")
    p.add_argument("--pipeline_status", action="store_true",
                   help="print per-stage rates")
    p.add_argument("--checkpoint_path", default="",
                   help="checkpoint file; with --resume, restore from it")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="checkpoint every N emitted chunk boundaries "
                        "(requires --no-use_pipeline)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint_path")
    p.add_argument("--solver_param", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="override an OversegParams field (repeatable), "
                        "e.g. --solver_param preseg_fin_margin=1.5 — the "
                        "CLI face of the reference's per-option "
                        "segmentation proto knobs (seg_tree.cpp:174-213)")
    p.add_argument("--region_param", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="override a RegionSegmentationOptions field "
                        "(repeatable), e.g. --region_param "
                        "agglo_subrounds=12")
    return p


def _apply_overrides(obj, pairs, flag, setter):
    """Apply `name=value` overrides onto dataclass/NamedTuple fields;
    values coerce to the field's existing type (bool accepts
    0/1/true/false, tuples parse comma-separated ints)."""
    for pair in pairs:
        name, _, raw = pair.partition("=")
        if not hasattr(obj, name):
            raise SystemExit(f"{flag}: unknown field {name!r}")
        cur = getattr(obj, name)
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            # int fields accept a comma tuple (per-level counts, e.g.
            # preseg_rounds_per_level=24,2,2).
            val = (tuple(int(x) for x in raw.split(",") if x)
                   if "," in raw else int(raw))
        elif isinstance(cur, float):
            val = float(raw)
        elif isinstance(cur, tuple):
            val = tuple(int(x) for x in raw.split(",") if x)
        else:
            val = raw
        obj = setter(obj, name, val)
    return obj


def _solver_params_from_flags(pairs):
    """None, or OversegParams with `name=value` overrides applied."""
    if not pairs:
        return None
    from video_segment_tpu.core import oversegmentation as ov
    return _apply_overrides(ov.OversegParams(), pairs, "--solver_param",
                            lambda o, n, v: o._replace(**{n: v}))


def _region_options_from_flags(pairs):
    """RegionSegmentationOptions with `name=value` overrides applied."""
    from video_segment_tpu.core.options import RegionSegmentationOptions

    def set_field(o, n, v):
        setattr(o, n, v)
        return o

    return _apply_overrides(RegionSegmentationOptions(), pairs,
                            "--region_param", set_field)


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    # Heavy imports after flag parsing (fast --help).
    import numpy as np
    from video_segment_tpu.core import dense
    from video_segment_tpu.core.options import DenseSegmentationOptions
    from video_segment_tpu.dataio import emit, seg_io, video
    from video_segment_tpu.segment_util import render as render_util

    if args.run_on_server:
        args.downscale_min_size = args.downscale_min_size or 360
        args.write_to_file = True

    downscale = "to_min" if args.downscale_min_size else "none"
    reader = video.VideoReader(args.input_file, downscale=downscale,
                               downscale_size=args.downscale_min_size,
                               trim_to=args.trim_to)
    info = reader.info
    print(f"Processing {args.input_file}: {info.width}x{info.height} "
          f"@ {info.fps:.2f} fps")

    flow_fn = None
    flow_mod = None
    if not args.flow:
        args.display_flow = False  # seg_tree.cpp:96
    if args.flow:
        from video_segment_tpu.core import flow as flow_mod
        # Reuse <input>.flow transparently when present (seg_tree.cpp:120-126);
        # write it when --save_flow.
        cache = args.input_file + ".flow"
        if not (args.save_flow or os.path.exists(cache)):
            cache = None
        ftype = {"backward": flow_mod.FLOW_BACKWARD,
                 "forward": flow_mod.FLOW_FORWARD,
                 "both": flow_mod.FLOW_BOTH}[args.flow_type]
        flow_fn = flow_mod.FlowEngine(info.width, info.height,
                                      cache_path=cache, flow_type=ftype)

    # Deferred host tail overlaps post-solve host work with the next
    # chunk's device work; checkpointing needs the synchronous tail (saved
    # state must match the frames already written to the output).
    opts = DenseSegmentationOptions(chunk_size=args.chunk_size,
                                    async_tail=not args.checkpoint_every)
    ds = dense.DenseSegmentation(
        opts, info.width, info.height,
        solver_params=_solver_params_from_flags(args.solver_param))

    region_stage = None
    save_descriptors = False
    if not args.over_segment:
        from video_segment_tpu.core import region
        ropts = _region_options_from_flags(args.region_param)
        save_descriptors = ropts.save_descriptors
        region_stage = region.RegionSegmentation(ropts,
                                                 info.width, info.height)

    resume_from = 0
    if args.resume:
        from video_segment_tpu.runtime import checkpoint as ckpt_mod
        if not args.checkpoint_path:
            sys.exit("--resume requires --checkpoint_path")
        if flow_fn is not None and flow_fn._reader is None:
            sys.exit("--resume with flow requires a <input>.flow cache "
                     "(run once with --save_flow)")
        resume_from = ckpt_mod.restore(args.checkpoint_path, ds,
                                       region_stage)
        reader.seek(resume_from)
        if flow_fn is not None:
            # Skip cached flow records already consumed before the cut
            # (the .flow file has one record set per frame from frame 1 on).
            for _ in range(max(resume_from - 1, 0)):
                flow_fn._read_cached()
        print(f"resumed from {args.checkpoint_path} at frame {resume_from}")

    writer = None
    if args.write_to_file:
        out_path = args.output_file or (args.input_file + ".pb")
        writer = seg_io.SegmentationWriter(out_path)
        ckpt_extra = {}
        if args.resume:
            from video_segment_tpu.runtime import checkpoint as ckpt_mod
            ckpt_extra = ckpt_mod.load_extra(args.checkpoint_path)
        if ckpt_extra.get("writer_offset"):
            # Continue the partially written container after its last
            # complete chunk instead of truncating it from the top.
            ok = writer.open_for_append(ckpt_extra["writer_offset"],
                                        ckpt_extra["writer_chunks"])
        elif args.resume and resume_from > 0 and os.path.exists(out_path):
            sys.exit(f"--resume would truncate {out_path} (checkpoint "
                     f"carries no writer position); move it aside or use "
                     f"--output_file")
        else:
            ok = writer.open_file(header_flags=[0, 1])
        if not ok:
            print(f"cannot open {out_path}", file=sys.stderr)
            return 1

    # Like the reference (seg_tree.cpp --render_and_save): one video per
    # fractional level 0.1 / 0.4 / 0.75 (a single level-0 video when running
    # over-segmentation only).
    render_writers = []
    if args.render_and_save:
        # Renders go next to the .pb output (or cwd), never next to a
        # possibly read-only input.
        base_dir = (os.path.dirname(os.path.abspath(args.output_file))
                    if args.output_file else os.getcwd())
        base = os.path.join(
            base_dir,
            os.path.splitext(os.path.basename(args.input_file))[0])
        levels = [0.0] if args.over_segment else [0.1, 0.4, 0.75]
        for lv in levels:
            path = f"{base}_render_{int(lv * 100):02d}.mp4"
            render_writers.append(
                (lv, video.VideoWriter(path, info.width, info.height,
                                       info.fps)))

    vectorize = args.write_to_file and not args.over_segment
    # Reference parity: --write_to_file always strips rasterization and
    # keeps vectorization (seg_tree.cpp:308 sets remove_rasterization=true);
    # --keep_rasterization retains the RLE rasters alongside.  When
    # segmenting a downscaled video the stream carries the original
    # resolution through scaled vectorization (writer-unit upscale path),
    # which forces the strip regardless.
    upscale_dims = None
    strip_raster = vectorize and not args.keep_rasterization
    if vectorize and (info.width, info.height) != (info.orig_width,
                                                   info.orig_height):
        upscale_dims = (info.orig_width, info.orig_height)
        strip_raster = True

    # Live display with a runtime hierarchy-level slider and source
    # blending — the SegmentationDisplayUnit feature set
    # (video_display_qt_unit.cpp:182-330) on cv2 HighGUI (no Qt in this
    # environment; the reference's slider is a percentage too).
    display = None
    display_level = [max(args.display, 0.0)]
    if args.display >= 0:
        import cv2
        try:
            cv2.namedWindow("seg_tree")
            cv2.createTrackbar(
                "level %", "seg_tree", int(display_level[0] * 100), 100,
                lambda v: display_level.__setitem__(0, v / 100.0))
            display = cv2
        except cv2.error:
            print("display unavailable (headless); ignoring --display",
                  file=sys.stderr)

    current_hierarchy = [None]
    display_frames: dict = {}   # frame_index -> source frame (display only)

    def consume_one(sf):
        nonlocal n_out
        if sf.hierarchy is not None:
            from video_segment_tpu.dataio import emit as emit_mod
            current_hierarchy[0] = emit_mod.hierarchy_to_proto(sf.hierarchy)
        if writer is not None:
            writer.add_to_chunk(
                emit.segframe_to_bytes(sf, vectorize=vectorize,
                                       remove_rasterization=strip_raster,
                                       output_dims=upscale_dims,
                                       save_descriptors=save_descriptors),
                pts=reader.pts_of(sf.frame_index))
            if sf.hierarchy is not None and n_out > 0:
                writer.write_chunk()
        if render_writers or display is not None:
            from video_segment_tpu.segment_util import util as su
            hier = current_hierarchy[0]
            for frac, vw in render_writers:
                lvl = su.absolute_level(hier, frac)
                vw.write(render_util.render_segframe(sf, hier, lvl))
            if display is not None:
                lvl = su.absolute_level(hier, display_level[0])
                img = render_util.render_segframe(sf, hier, lvl)
                src = display_frames.pop(sf.frame_index, None)
                a = min(max(args.blend_alpha, 0.0), 1.0)
                if src is not None and a < 1.0 and src.shape == img.shape:
                    img = display.addWeighted(img, a, src, 1.0 - a, 0.0)
                display.imshow("seg_tree", img)
                display.waitKey(1)
        n_out += 1
        if n_out % 20 == 0:
            print(f"__STREAMING_SIZE__: {n_out}")

    # xprof-compatible device trace (SURVEY §5 tracing equivalent): set
    # VST_PROFILE=<dir> to capture a jax.profiler trace of the run; the
    # solver/agglomeration phases carry jax.named_scope annotations.
    profile_dir = os.environ.get("VST_PROFILE", "")
    if profile_dir:
        import jax
        jax.profiler.start_trace(profile_dir)

    t0 = time.time()
    n_out = 0

    flow_display = None
    if args.display_flow:
        import cv2
        try:
            cv2.namedWindow("seg_tree flow")
            flow_display = cv2
        except cv2.error:
            print("display unavailable (headless); ignoring --display_flow",
                  file=sys.stderr)

    def _emit_flow(ready):
        out = []
        for idx, frame, fl in ready:
            fwd, bwd = None, fl
            if flow_mod is not None and isinstance(fl, flow_mod.FlowPair):
                fwd, bwd = fl.forward, fl.backward
            if flow_display is not None:
                # Render forward flow if computed, else backward
                # (flow_reader.cpp:277-305: render_flow priority).
                rf = fwd if fwd is not None else bwd
                if rf is not None:
                    flow_display.imshow("seg_tree flow",
                                        flow_mod.flow_to_hsv_bgr(rf))
                    flow_display.waitKey(1)
            if region_stage is not None:
                region_stage.add_frame(idx, frame, bwd)
            if display is not None:
                display_frames[idx] = frame   # blended at display time
            out.append((frame, bwd))
        return out

    def flow_stage(item):
        idx, frame = item
        if flow_fn is None:
            return _emit_flow([(idx, frame, None)])
        return _emit_flow(flow_fn.push(frame, idx))

    def flow_flush():
        return _emit_flow(flow_fn.flush()) if flow_fn is not None else []

    def dense_stage(item):
        frame, fl = item
        return ds.process_frame(False, frame, fl)

    def region_fn(sf):
        return region_stage.process_frames(False, [sf])

    if args.use_pipeline:
        from video_segment_tpu.runtime import pipeline as pl

        stages = [pl.Stage("flow", flow_stage, flush=flow_flush),
                  pl.Stage("dense", dense_stage,
                           flush=lambda: ds.process_frame(True))]
        if region_stage is not None:
            stages.append(pl.Stage(
                "region", region_fn,
                flush=lambda: region_stage.process_frames(True, [])))
        # Reference pipeline-mode rate policy (seg_tree.cpp:339-351):
        # 20 fps cap, dynamic updates every second after 10 frames,
        # camera mode throttles earlier and undershoots the slowest stage.
        use_camera = args.input_file == "CAMERA"
        rp = pl.RatePolicy(
            max_rate=args.max_rate, dynamic_rate=args.dynamic_rate,
            dynamic_rate_scale=0.9 if use_camera else 1.1,
            startup_frames=10, update_interval=1.0,
            queue_throttle_threshold=3 if use_camera else 10)
        pipe = pl.Pipeline(stages, queue_size=10, rate_policy=rp)
        printer = (pl.StatusPrinter(pipe) if args.pipeline_status
                   else None)
        try:
            if printer:
                printer.__enter__()
            for sf in pipe.run(
                    (resume_from + k, fr)
                    for k, fr in enumerate(reader)):
                consume_one(sf)
        finally:
            if printer:
                printer.__exit__()
    else:
        n_in = resume_from
        last_ckpt_chunk = ds._chunk_id
        for frame in reader:
            for pair in flow_stage((n_in, frame)):
                out = dense_stage(pair)
                if region_stage is not None:
                    out = [o for sf in out for o in region_fn(sf)]
                for sf in out:
                    consume_one(sf)
            n_in += 1
            if (args.checkpoint_every and args.checkpoint_path
                    and ds._chunk_id > last_ckpt_chunk
                    and ds._chunk_id % args.checkpoint_every == 0):
                from video_segment_tpu.runtime import checkpoint as ckpt_mod
                # Frames still buffered inside the flow engine have not
                # reached the dense/region stages; resume must re-feed them.
                n_done = n_in - (len(flow_fn._pending)
                                 if flow_fn is not None else 0)
                extra = {}
                if writer is not None:
                    # Flush buffered frames so the container ends on a
                    # complete chunk; record the position for append.
                    writer.write_chunk()
                    extra = {"writer_offset": writer.tell(),
                             "writer_chunks": writer.num_chunks}
                ckpt_mod.save(args.checkpoint_path, ds, region_stage,
                              frames_consumed=n_done, extra=extra)
                last_ckpt_chunk = ds._chunk_id
        out = []
        for pair in flow_flush():
            out.extend(dense_stage(pair))
        out.extend(ds.process_frame(True))
        if region_stage is not None:
            out = ([o for sf in out for o in region_fn(sf)]
                   + region_stage.process_frames(True, []))
        for sf in out:
            consume_one(sf)

    if writer is not None:
        writer.write_term_and_close()
    for _, vw in render_writers:
        vw.close()
    reader.close()
    if flow_fn is not None:
        flow_fn.close()

    if profile_dir:
        import jax
        jax.profiler.stop_trace()
        print(f"profiler trace written to {profile_dir}")

    dt = time.time() - t0
    fps = n_out / dt if dt > 0 else 0.0
    print(f"Processed {n_out} frames in {dt:.2f}s ({fps:.2f} fps)")
    print("__SEGMENTATION_FINISHED__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
