"""CLI of the PyTorch / CUDA port: ``python -m grid_vision_tpu_torch
<command>`` (counterpart of ``python -m grid_vision_tpu``).

  run     stream a synthetic sequence through the engine over the packed
          wire (runtime/stream.replay) with a config YAML (the reference
          YAML works as-is); --timings logs the three stage timers;
          --publish NAME exposes the session (runtime/session.py); --track
          adds the multi-object tracker (stable ids and base-frame
          velocities from the shipped weights' detections, logged each
          tick and published as track markers)
  record  record a packed-wire sensor drive to a .gvr file (the rosbag
          equivalent; the JAX package's format)
  play    re-drive the engine from a .gvr recording byte for byte
  serve   the fleet server (runtime/serve.py): N rigs' sensor mailboxes
          -> one fleet tick on the card -> per-rig sessions; --shared
          fuses every rig into one world grid, --track / --forecast add
          the tracker and predictive occupancy, --selftest feeds the rigs
          from synthetic scenes
  train   fit the detector (train detector) or the orientation net (train
          orientation) on the card: batches drawn there, a readback a
          chunk of --scan steps (train/fit_on_device.py,
          train/fit_orientation.py)
  eval    detection quality: COCO-style mAP@0.5 on held-out scenes
          (train/eval_map.py)
  eval-pose  3D localization error against scene ground truth
          (train/eval_pose.py)

Every command runs on the card; --cpu runs it on the CPU. Not ported yet:
view, demo, bench.

Examples:
  python -m grid_vision_tpu_torch run --config config/grid_vision_cfg.yaml
  python -m grid_vision_tpu_torch run --cpu --steps 3
  python -m grid_vision_tpu_torch run --track --steps 40
  python -m grid_vision_tpu_torch record --out drive.gvr --steps 100
  python -m grid_vision_tpu_torch play drive.gvr --chunk 8
  python -m grid_vision_tpu_torch serve --selftest --rigs 64 --steps 100
  python -m grid_vision_tpu_torch serve --selftest --shared --rigs 8
  python -m grid_vision_tpu_torch train detector --steps 1000
  python -m grid_vision_tpu_torch train orientation
  python -m grid_vision_tpu_torch eval --source scene --images 64
  python -m grid_vision_tpu_torch eval-pose --mode both --frames 32
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

NOT_PORTED = ("view", "demo", "bench")


def _run(argv) -> None:
    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch run")
    ap.add_argument("--config", default=None,
                    help="parameter YAML (reference format accepted)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--hz", type=float, default=10.0)
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--publish", default=None, metavar="SESSION",
                    help="publish grid/markers/overlay to the session "
                         "SESSION (runtime/session.py)")
    ap.add_argument("--timings", action="store_true",
                    help="log per-stage latencies each tick (the "
                         "reference's detection/orientation timers)")
    ap.add_argument("--track", action="store_true",
                    help="run the multi-object tracker (ops/tracking.py): "
                         "stable ids and base-frame velocities, logged each "
                         "tick and published as track markers")
    args = ap.parse_args(argv)

    from .config import GridVisionConfig, load_config
    from .demo import default_extrinsics
    from .io.scene import SyntheticScene
    from .pipeline import Engine
    from .runtime.stream import obs_from_scene, replay
    from .utils.stats import logger

    logging.basicConfig(level=logging.INFO)
    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.config) if args.config else GridVisionConfig()
    if args.track:
        cfg = _with_shipped_weights(cfg)
    eng = Engine(cfg, extrinsics=default_extrinsics(device), device=device)
    scene = SyntheticScene(cfg, seed=0)
    scene.add_default_traffic()
    period = 1.0 / args.hz
    pub = on_step = None
    if args.publish:
        from .runtime.session import SessionPublisher
        pub = SessionPublisher(args.publish, cfg)
        ex = eng.extrinsics
        l2b = (ex.camera_to_base @ ex.lidar_to_camera).cpu().numpy()

        def on_step(i, state, out):
            pts = scene.cloud_at(i * period)
            cloud_base = pts @ l2b[:3, :3].T + l2b[:3, 3]
            pub.publish(i, out, image=scene.image_at(i * period),
                        cloud_xyz=cloud_base)
        logger.info("publishing session %r", args.publish)
    if args.track:
        _run_tracked(args, eng, scene, pub, period, device)
    elif args.timings:
        from .runtime.timing import TimedEngine
        timed = TimedEngine(eng)
        state = eng.init_state()
        t0 = time.perf_counter()
        for i in range(args.steps):
            obs = obs_from_scene(scene, i * period, cfg, device)
            state, out, times = timed.step(state, obs)
            logger.info("step %d: %s", i, times)
            if on_step is not None:
                on_step(i, state, out)
            if args.realtime:
                sleep = (i + 1) * period - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
    else:
        res = replay(eng, scene, n_steps=args.steps, hz=args.hz,
                     realtime=args.realtime, on_step=on_step)
        logger.info("replayed %d steps at %.1f Hz (wall %.2fs)",
                    res.n_steps, res.achieved_hz, res.wall_s)
    if pub is not None:
        pub.close()


def _with_shipped_weights(cfg):
    """The tracker needs real detections: the shipped checkpoints wherever
    the config names none (the JAX CLI's rule)."""
    import dataclasses
    import os
    w = {}
    if not cfg.detection_weights_file and os.path.exists(
            "weights/detector.npz"):
        w["detection_weights_file"] = "weights/detector.npz"
    if (cfg.use_vision_orientation and not cfg.vision_weights_file
            and os.path.exists("weights/orientation.npz")):
        w["vision_weights_file"] = "weights/orientation.npz"
    return dataclasses.replace(cfg, **w) if w else cfg


def _run_tracked(args, eng, scene, pub, period, device) -> None:
    """run --track: Engine.call_tracked on each scene frame at
    dt = 1 / hz, a log line a tick with the confirmed tracks."""
    from .io.viz import track_markers
    from .ops.tracking import TrackConfig
    from .runtime.stream import obs_from_scene
    from .utils.stats import logger

    tcfg = TrackConfig()
    state, tracks = eng.init_state(), eng.init_tracks(tcfg)
    t0 = time.perf_counter()
    for i in range(args.steps):
        obs = obs_from_scene(scene, i * period, eng.cfg, device)
        state, tracks, out, _ = eng.call_tracked(state, tracks, obs,
                                                 dt=period, tcfg=tcfg)
        tm = track_markers(tracks, tcfg)
        cubes = [m for m in tm if m["ns"] == "track"]
        logger.info(
            "step %d: %d confirmed tracks  %s", i, len(cubes),
            "  ".join(f"{m['label']} v={m['speed_mps']:.1f}m/s"
                      if m["speed_mps"] is not None else m["label"]
                      for m in cubes))
        if pub is not None:
            pub.publish(i, out, image=scene.image_at(i * period),
                        extra_markers=tm)
        if args.realtime:
            sleep = (i + 1) * period - (time.perf_counter() - t0)
            if sleep > 0:
                time.sleep(sleep)


def _record(argv) -> None:
    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch record")
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--hz", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="accepted for symmetry: recording runs on the "
                         "host only")
    a = ap.parse_args(argv)
    from .config import GridVisionConfig, load_config
    from .runtime.record import record_scene
    cfg = load_config(a.config) if a.config else GridVisionConfig()
    n = record_scene(a.out, cfg, a.steps, hz=a.hz, seed=a.seed)
    print(f"recorded {n} frames -> {a.out}")


def _play(argv) -> None:
    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch play")
    ap.add_argument("path")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--session", default=None,
                    help="publish to the session NAME")
    ap.add_argument("--grid-out", default=None, metavar="FILE.gvg",
                    help="record the output occupancy stream "
                         "(keyframe+delta codec, io/grid_codec.py)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    from .runtime.record import play
    n, _state = play(a.path, chunk=a.chunk, session=a.session,
                     grid_out=a.grid_out,
                     device="cpu" if a.cpu else "cuda")
    print(f"played {n} frames from {a.path}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "run":
        _run(rest)
    elif cmd == "record":
        _record(rest)
    elif cmd == "play":
        _play(rest)
    elif cmd == "serve":
        from .runtime.serve import main as serve_main
        serve_main(rest)
    elif cmd == "train":
        if not rest or rest[0] not in ("detector", "orientation"):
            print("usage: train {detector|orientation} [flags]",
                  file=sys.stderr)
            sys.exit(2)
        if rest[0] == "detector":
            from .train.fit_on_device import main as fit
        else:
            from .train.fit_orientation import main as fit
        fit(rest[1:])
    elif cmd == "eval":
        from .train.eval_map import main as eval_main
        eval_main(rest)
    elif cmd == "eval-pose":
        from .train.eval_pose import main as eval_pose_main
        eval_pose_main(rest)
    elif cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported to grid_vision_tpu_torch yet; "
              f"`python -m grid_vision_tpu {cmd}` runs the JAX package's",
              file=sys.stderr)
        sys.exit(2)
    else:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
