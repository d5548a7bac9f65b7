"""Shell entry point — the `roslaunch trajectory_optimization <name>.launch`
equivalent (SURVEY.md §1 L5 / §5 config system: dataclass configs + CLI
overrides reproducing the rosparam knob set).

    python -m trajectory_optimization_tpu_torch pose_optimization opt_steps=50 --steps 3
    python -m trajectory_optimization_tpu_torch trajectory_optimization \
        pc_topic=/pts path_topic=/path --play session.bag --echo /path/optimized
    python -m trajectory_optimization_tpu_torch play_bag --play session.bag --echo /tf
    python -m trajectory_optimization_tpu_torch info session.bag
    python -m trajectory_optimization_tpu_torch filter in.bag out.bag \
        --topics /tf /points --start 1.5e9 --compression bz2
    python -m trajectory_optimization_tpu_torch eval \
        data/points/point_cloud_10.npz data/paths/path_poses_10.npz --optimize 100
    python -m trajectory_optimization_tpu_torch extract session.bag data/ \
        --images /viz/camera_0/image/compressed --indices 10

Twin of the JAX package's ``__main__``, with the same arguments and output
lines, plus ``--device`` (default ``cuda``): the presets' nodes, node
processes included, and ``eval``'s ``TrajectoryOptimizer`` run there. It
takes the place of the ``JAX_PLATFORMS`` variable the JAX CLI relies on;
``--device cpu`` runs everything on the host.

`info PATH` prints a rosbag-info-style summary of a .bag (the reference
documents its dataset with exactly that output, `launch/rosbag_info.txt`);
it scans record headers + index records only, so a 15 GB session summarizes
in seconds. `filter SRC DST` copies selected topics / a time window into a
new bag with byte-identical payloads (rosbag filter; with no filters and
`--compression`, rosbag compress/decompress). Overrides are rosparam-style
``key=value`` strings applied to
the preset's node config (`utils.config.apply_overrides` — unknown keys
error). Presets mirror the reference launch files; `--processes` reproduces
its node-per-OS-process runtime shape.
"""
from __future__ import annotations

import argparse
import sys

PRESETS = (
    "trajectory_optimization",
    "pose_optimization",
    "pointcloud_processor",
    "voxels_filtering",
    "play_bag",
)

# default output topics summarized after a run, per preset
_WATCH = {
    "trajectory_optimization": ("{path_topic}/optimized",),
    "pose_optimization": ("/odom",),
    "voxels_filtering": ("{output_topic}",),
}


def _build(args):
    """Construct the preset's Launch handle with overrides applied."""
    from trajectory_optimization_tpu_torch.bus import launch as L
    from trajectory_optimization_tpu_torch.utils import config as C

    ov = list(args.overrides)
    if args.preset == "trajectory_optimization":
        cfg = C.apply_overrides(L.default_trajopt_config(), ov)
        handle = L.launch_trajectory_optimization(
            overrides=cfg, processes=args.processes, viewer=args.viewer,
            device=args.device, **({"data_dir": args.data_dir} if args.data_dir else {}))
        watch = [t.format(path_topic=cfg.path_topic) for t in _WATCH[args.preset]]
    elif args.preset == "pose_optimization":
        cfg = C.apply_overrides(L.default_poseopt_config(), ov)
        handle = L.launch_pose_optimization(
            overrides=cfg, processes=args.processes, viewer=args.viewer,
            device=args.device, **({"data_dir": args.data_dir} if args.data_dir else {}))
        watch = list(_WATCH[args.preset])
    elif args.preset == "pointcloud_processor":
        cfg = C.apply_overrides(C.PointsProcessorConfig(), ov)
        handle = L.launch_pointcloud_processor(
            overrides=cfg, processes=args.processes, device=args.device)
        # output topics derive from CameraInfoMsg.header.frame_id, unknown
        # until messages flow — use --echo with the actual frame topics
        watch = []
    elif args.preset == "voxels_filtering":
        if args.processes:
            raise SystemExit("voxels_filtering has no --processes variant")
        cfg = C.apply_overrides(C.VoxelFilterConfig(), ov)
        handle = L.launch_voxels_filtering(
            input_topic=cfg.input_topic, output_topic=cfg.output_topic,
            leaf_size=cfg.leaf_size, z_limits=cfg.z_limits)
        watch = [t.format(output_topic=cfg.output_topic)
                 for t in _WATCH[args.preset]]
    else:  # play_bag: bare bus, replay only
        if ov:
            raise SystemExit("play_bag takes no config overrides")
        if args.processes:
            raise SystemExit("play_bag has no --processes variant")
        from trajectory_optimization_tpu_torch.bus.core import Bus

        handle = L.Launch(Bus(), {}, [])
        watch = []
    return handle, watch


def _describe(msg) -> str:
    import numpy as np

    name = type(msg).__name__
    stamp = getattr(getattr(msg, "header", None), "stamp", None)
    for attr in ("points", "positions", "data"):
        v = getattr(msg, attr, None)
        if isinstance(v, np.ndarray) or hasattr(v, "shape"):
            return f"{name} stamp={stamp} {attr}{tuple(v.shape)}"
    return f"{name} stamp={stamp}"


def _info(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m trajectory_optimization_tpu_torch info",
        description="Print a rosbag-info-style summary of a .bag file.",
    )
    p.add_argument("path", help=".bag file to summarize")
    args = p.parse_args(argv)
    from trajectory_optimization_tpu_torch.bus.rosbag import bag_info

    try:
        print(bag_info(args.path).format())
    except (OSError, ValueError) as e:
        print(f"info: {e}", file=sys.stderr)
        return 1
    return 0


def _filter(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m trajectory_optimization_tpu_torch filter",
        description="Copy a .bag keeping selected topics / a time window "
                    "(byte-identical payloads; rosbag filter/compress/"
                    "decompress equivalent).",
    )
    p.add_argument("src", help="input .bag")
    p.add_argument("dst", help="output .bag")
    p.add_argument("--topics", nargs="+", default=None, metavar="TOPIC",
                   help="keep only these topics (default: all)")
    p.add_argument("--start", type=float, default=None, metavar="T",
                   help="keep messages with bag time >= T (seconds)")
    p.add_argument("--end", type=float, default=None, metavar="T",
                   help="keep messages with bag time <= T (seconds)")
    p.add_argument("--compression", choices=("none", "bz2", "lz4"),
                   default="none", help="output chunk compression")
    args = p.parse_args(argv)
    from trajectory_optimization_tpu_torch.bus.rosbag import filter_bag

    try:
        n = filter_bag(args.src, args.dst, topics=args.topics,
                       start=args.start, end=args.end,
                       compression=args.compression)
    except (OSError, ValueError) as e:
        print(f"filter: {e}", file=sys.stderr)
        return 1
    print(f"wrote {n} messages to {args.dst}")
    return 0


def _eval(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m trajectory_optimization_tpu_torch eval",
        description="Trajectory Evaluation (reference README cam_traj_eval "
                    "mode): observed-voxel census of a fixed path against a "
                    "cloud, rewards fused by OctoMap log-odds.",
    )
    p.add_argument("cloud", help="point-cloud .npz (key 'pts')")
    p.add_argument("path", help="waypoint path .npz (key 'poses')")
    p.add_argument("--voxel", type=float, default=0.0, metavar="LEAF",
                   help="first voxel-downsample the cloud at LEAF meters "
                        "(evaluate on literal voxels)")
    p.add_argument("--optimize", type=int, default=0, metavar="N",
                   help="also optimize the path N steps and report the gain")
    p.add_argument("--device", default="cuda",
                   help="torch device of the evaluation (default cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.utils.data import load_path, load_point_cloud

    try:
        pts = load_point_cloud(args.cloud)
        path = load_path(args.path)
    except (OSError, KeyError, ValueError) as e:
        print(f"eval: {e}", file=sys.stderr)
        return 1
    if args.voxel > 0:
        from trajectory_optimization_tpu_torch.ops.voxel import voxel_downsample

        pts = np.asarray(voxel_downsample(pts, args.voxel))
    opt = TrajectoryOptimizer(device=args.device)
    # one stride for BOTH censuses: recomputing it from the optimized path
    # could select a different waypoint subset, making the gain meaningless
    from trajectory_optimization_tpu_torch.models.traj import waypoint_stride

    stride = waypoint_stride(path, opt.vis_wps_dist)

    def report(tag, ev):
        print(f"{tag}: observed {ev.n_observed}/{len(pts)} "
              f"({100 * ev.frac_observed:.1f}%), mean reward "
              f"{ev.mean_reward:.4f}, length {ev.length:.2f} m, "
              f"mean angle {ev.mean_angle:.3f} rad")

    ev = opt.evaluate(pts, path, wps_step=stride)
    report("initial  ", ev)
    if args.optimize > 0:
        res = opt.optimize(pts, path, n_steps=args.optimize)
        ev1 = opt.evaluate(
            pts, res.poses.astype(np.float32), res.quats_wxyz.astype(np.float32),
            wps_step=stride)
        report("optimized", ev1)
        print(f"gain: x{ev1.n_observed / max(ev.n_observed, 1):.2f} observed, "
              f"x{ev1.mean_reward / max(ev.mean_reward, 1e-9):.2f} mean reward")
    return 0


def _extract(argv) -> int:
    p = argparse.ArgumentParser(
        prog="python -m trajectory_optimization_tpu_torch extract",
        description="Extract the reference npz dataset layout "
                    "(data/points/point_cloud_{i}.npz + data/paths/"
                    "path_poses_{i}.npz, plus optional camera PNG frames "
                    "and intrinsics) from a recorded session .bag.",
    )
    p.add_argument("bag", help="input .bag (e.g. the reference's 15 GB "
                               "session recording)")
    p.add_argument("out", help="output dataset directory")
    p.add_argument("--cloud-topic", default=None, metavar="TOPIC",
                   help="PointCloud2 topic -> points/point_cloud_{i}.npz "
                        "(default /final_cost_cloud; '' disables)")
    p.add_argument("--path-topic", default=None, metavar="TOPIC",
                   help="nav_msgs/Path topic -> paths/path_poses_{i}.npz "
                        "(default /path; '' disables)")
    p.add_argument("--images", nargs="+", default=(), metavar="TOPIC",
                   help="image topics -> images/<topic>/frame_{i}.png "
                        "(CompressedImage streams decode through the "
                        "from-spec JPEG/PNG codecs)")
    p.add_argument("--camera-info", nargs="+", default=(), metavar="TOPIC",
                   help="CameraInfo topics -> images/<topic>/camera_info.npz")
    p.add_argument("--indices", nargs="+", type=int, default=None,
                   metavar="I", help="only these per-topic message indices "
                                     "(e.g. --indices 10 reproduces the "
                                     "in-repo sample pair)")
    p.add_argument("--start-index", type=int, default=0, metavar="N",
                   help="offset added to indices in output file names")
    args = p.parse_args(argv)
    from trajectory_optimization_tpu_torch.bus.dataset import (
        DEFAULT_CLOUD_TOPIC,
        DEFAULT_PATH_TOPIC,
        extract_dataset,
    )

    cloud = DEFAULT_CLOUD_TOPIC if args.cloud_topic is None else args.cloud_topic
    path = DEFAULT_PATH_TOPIC if args.path_topic is None else args.path_topic
    try:
        res = extract_dataset(
            args.bag, args.out, cloud_topic=cloud, path_topic=path,
            image_topics=args.images, camera_info_topics=args.camera_info,
            indices=args.indices, start_index=args.start_index)
    except (OSError, ValueError) as e:
        print(f"extract: {e}", file=sys.stderr)
        return 1
    if res.n_files == 0:
        print("extract: no matching messages found — check topic names "
              "with `info`", file=sys.stderr)
        return 1
    n_img = sum(len(v) for v in res.images.values())
    print(f"wrote {len(res.clouds)} clouds, {len(res.paths)} paths, "
          f"{n_img} image frames, {len(res.camera_infos)} camera infos "
          f"to {args.out}"
          + (f" ({res.skipped_images} undecodable frames skipped)"
             if res.skipped_images else ""))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "info":
        return _info(argv[1:])
    if argv and argv[0] == "filter":
        return _filter(argv[1:])
    if argv and argv[0] == "eval":
        return _eval(argv[1:])
    if argv and argv[0] == "extract":
        return _extract(argv[1:])
    p = argparse.ArgumentParser(
        prog="python -m trajectory_optimization_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("preset",
                   choices=PRESETS + ("info", "filter", "eval", "extract"),
                   help="launch preset, the bag tools `info PATH` / "
                        "`filter SRC DST [--topics ...]` / "
                        "`extract BAG OUT` (bag -> npz dataset), or "
                        "`eval CLOUD.npz PATH.npz` (trajectory evaluation)")
    p.add_argument("overrides", nargs="*", metavar="key=value",
                   help="rosparam-style overrides for the preset's node config")
    p.add_argument("--processes", action="store_true",
                   help="run nodes as separate OS processes (reference shape)")
    p.add_argument("--viewer", action="store_true",
                   help="serve the live HTTP scene viewer (the rviz role) "
                        "on the optimizer presets; URL printed at launch")
    p.add_argument("--steps", type=int, default=None, metavar="N",
                   help="drive the feeders N deterministic cycles")
    p.add_argument("--spin", type=float, default=None, metavar="SECONDS",
                   help="run feeders threaded for SECONDS at --rate Hz")
    p.add_argument("--rate", type=float, default=1.0,
                   help="feeder/replay rate multiplier (default 1.0)")
    p.add_argument("--play", metavar="PATH",
                   help="replay a ROS1 .bag file or npz recording dir into the graph")
    p.add_argument("--realtime", action="store_true",
                   help="replay at recorded timing (default: as fast as possible)")
    p.add_argument("--loop", type=int, default=1, metavar="N",
                   help="replay the recording N times (rosbag play -l)")
    p.add_argument("--start-offset", type=float, default=0.0, metavar="SEC",
                   help="skip the first SEC seconds of bag time (rosbag play -s)")
    p.add_argument("--duration", type=float, default=None, metavar="SEC",
                   help="replay only SEC seconds past the offset (rosbag play -u)")
    p.add_argument("--data-dir", default=None,
                   help="feeder data directory (presets with feeders)")
    p.add_argument("--echo", nargs="*", default=(), metavar="TOPIC",
                   help="print one line per message on these topics")
    p.add_argument("--device", default="cuda",
                   help="torch device of the presets' nodes, node processes "
                        "included (default cuda; cpu runs on the host)")
    p.add_argument("--drain", type=float, default=240.0, metavar="SECONDS",
                   help="with --processes: max time to wait for worker "
                        "outputs to quiesce before teardown (default 240)")
    p.add_argument("--record", metavar="PATH",
                   help="record bus traffic to a .bag (rosbag-record "
                        "equivalent; all topics unless --record-topics)")
    p.add_argument("--record-topics", nargs="*", default=None,
                   metavar="TOPIC", help="restrict --record to these topics")
    p.add_argument("--record-split-size", type=float, default=None,
                   metavar="MB", help="roll the recording to a new bag "
                   "every MB megabytes (rosbag record --split --size)")
    p.add_argument("--record-split-duration", type=float, default=None,
                   metavar="SEC", help="roll the recording every SEC "
                   "seconds of message time (rosbag record --split "
                   "--duration)")
    p.add_argument("--record-compression", choices=("none", "bz2", "lz4"),
                   default="none", help="compress recorded chunks "
                   "(rosbag record --bz2/--lz4)")
    args = p.parse_args(argv)
    if args.preset == "play_bag" and not args.play:
        p.error("play_bag requires --play PATH")
    if args.record_topics is not None and not args.record:
        p.error("--record-topics requires --record")
    if args.record_topics is not None and not args.record_topics:
        p.error("--record-topics needs at least one topic "
                "(omit it to record every topic)")
    if not args.play and (args.loop != 1 or args.start_offset
                          or args.duration is not None):
        p.error("--loop/--start-offset/--duration require --play PATH")
    if args.loop < 1:
        p.error("--loop must be >= 1")
    if ((args.record_split_size is not None
         or args.record_split_duration is not None
         or args.record_compression != "none") and not args.record):
        p.error("--record-split-*/--record-compression require --record PATH")
    if args.record_split_size is not None and args.record_split_size <= 0:
        p.error("--record-split-size must be positive megabytes")
    if args.record_split_duration is not None and args.record_split_duration <= 0:
        p.error("--record-split-duration must be positive seconds")

    handle, watch = _build(args)
    counts = {}

    def _count(topic):
        def cb(msg, _t=topic):
            counts[_t] = counts.get(_t, 0) + 1
        return cb

    for t in dict.fromkeys(list(watch) + list(args.echo)):
        handle.bus.subscribe(t, _count(t))
    for t in args.echo:
        handle.bus.subscribe(
            t, lambda m, _t=t: print(f"[{_t}] {_describe(m)}"))

    recorder = None
    rc = 0
    record_failed = False
    try:
        if args.record:
            from trajectory_optimization_tpu_torch.bus.rosbag import BagRecorder

            try:
                recorder = BagRecorder(
                    handle.bus, args.record_topics, args.record,
                    split_size=(int(args.record_split_size * (1 << 20))
                                if args.record_split_size is not None
                                else None),
                    split_duration=args.record_split_duration,
                    compression=args.record_compression)
            except OSError as e:
                raise SystemExit(f"cannot record to {args.record}: {e}")
        if args.play:
            from trajectory_optimization_tpu_torch.bus import launch as L

            n = L.launch_play_bag(args.play, handle,
                                  realtime=args.realtime, rate=args.rate,
                                  loop=args.loop, start=args.start_offset,
                                  duration=args.duration)
            print(f"replayed {n} messages from {args.play}")
        if args.spin is not None:
            handle.spin(args.spin, rate=args.rate)
        elif args.steps is not None or (not args.play and handle.feeders):
            for _ in range(args.steps if args.steps is not None else 1):
                handle.step()
        if args.processes:
            n_watched = len(dict.fromkeys(list(watch) + list(args.echo)))
            rc = _drain_processes(handle, counts, n_watched, args.drain)
    finally:
        try:
            # in-process close() flushes pipelined nodes BEFORE the summary
            # and the recorder close; cross-process outputs drained above
            handle.close()
        finally:
            if recorder is not None:
                try:
                    recorder.close()
                    # recorder.paths[0], not args.record: in splitting
                    # mode even a single file is named out_0.bag
                    where = (recorder.paths[0] if len(recorder.paths) == 1
                             else f"{len(recorder.paths)} files "
                                  f"({recorder.paths[0]} ..)")
                    print(f"recorded {recorder.count} messages to {where}"
                          + (f" ({recorder.skipped} unserializable skipped)"
                             if recorder.skipped else ""))
                except OSError as e:
                    print(f"recording FAILED: {e} — {recorder.count} "
                          "messages were encoded but the unflushed tail "
                          "(up to one ~1 MB chunk) is lost", file=sys.stderr)
                    record_failed = True

    if record_failed:
        rc = 1

    for t in dict.fromkeys(list(watch) + list(args.echo)):
        print(f"{t}: {counts.get(t, 0)} msgs")
    errors = getattr(handle.bus, "errors", [])
    if errors:
        print(f"{len(errors)} subscriber errors (first: {errors[0]})",
              file=sys.stderr)
        rc = 1
    return rc


def _drain_processes(handle, counts, n_watched: int, max_wait: float) -> int:
    """Cross-process nodes compute asynchronously (a worker's first result
    waits for its CUDA context and kernel library): wait for the first watched
    output, then until counts quiesce (no change for 3 s) or ``max_wait``
    elapses. Flag workers that died mid-run — their errors stay in the
    worker's private bus, so death is the parent-visible failure signal."""
    import time

    def _dead():
        return [name for name, node in handle.nodes.items()
                if hasattr(node, "alive") and not node.alive()]

    deadline = time.monotonic() + max_wait
    if n_watched:
        while (not sum(counts.values()) and not _dead()
               and time.monotonic() < deadline):
            time.sleep(0.5)
        last = dict(counts)
        last_change = time.monotonic()
        while time.monotonic() < min(deadline, last_change + 3.0):
            time.sleep(0.2)
            if counts != last:
                last = dict(counts)
                last_change = time.monotonic()
    dead = _dead()
    if dead:
        print(f"node process(es) died during the run: {dead} "
              "(set TRAJOPT_NODE_DEBUG=<path> for a worker-side log)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
