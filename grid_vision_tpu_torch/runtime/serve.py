"""Fleet serving: N rigs' sensor mailboxes -> one batched engine on the
card -> per-rig viewer sessions (counterpart of
grid_vision_tpu/runtime/serve.py; the same mailboxes, sessions and CLI).

The reference's deployment unit is one ROS node per vehicle
(src/grid_vision_node.cpp:533-540: one rig, one GPU). Here one process
owns the card and steps a whole fleet of rigs a tick (parallel/fleet.Fleet:
pipeline.fleet_step, each kernel once a tick over the rig batch), while
sensor producers (drivers, bridges, simulators: any process) write raw
frames into per-rig shared-memory mailboxes and viewers attach to per-rig
sessions:

    server:    python -m grid_vision_tpu_torch serve --rigs 4 --name fleet
    producer:  FleetClient("fleet", rig=2, cfg).publish_image(rgb8)
               ... .publish_cloud(xyz, intensity)
    viewer:    python -m grid_vision_tpu view --session fleet-r2

Per rig the semantics are the single-rig live loop's (runtime/live.py):
latest-wins mailboxes, stale frames reused like the reference's member
buffers, a missing sensor degrades through the Q1 gate (has_image /
has_cloud False). A slow viewer or an absent producer never holds the
fleet back. The frames cross to the card as the 8-bit pixels the
producers wrote (the tick takes uint8 frames; a quarter of the f32 bytes,
the same result). Outputs are read back at the publish cadence only.

`--selftest` runs one synthetic producer thread a rig in-process (one
SyntheticScene a rig): the demo and the test path.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import GridVisionConfig
from ..io.scene import SyntheticScene
from ..parallel.fleet import Fleet
from ..parallel.mesh import RigMesh, rig_mesh
from ..types import (Boxes, LShapePoses, Obs, PointCloud, SaturationStats,
                     StepOutput, stack)
from ..utils import prng
from . import native
from .session import CLOUDVIZ_MAX_POINTS, SessionPublisher

IMAGE_CHANNEL = "image"
CLOUD_CHANNEL = "cloud"


def rig_session(name: str, rig: int) -> str:
    return f"{name}-r{rig}"


def _image_box(name: str, rig: int, cfg: GridVisionConfig,
               create: bool) -> native.ShmMailbox:
    h, w = cfg.camera_image_height, cfg.camera_image_width
    return native.ShmMailbox(
        native.shm_path(rig_session(name, rig), IMAGE_CHANNEL),
        capacity=h * w * 3, create=create)


def _cloud_box(name: str, rig: int, cfg: GridVisionConfig,
               create: bool) -> native.ShmMailbox:
    return native.ShmMailbox(
        native.shm_path(rig_session(name, rig), CLOUD_CHANNEL),
        capacity=cfg.max_points * 16 * 4, create=create)


class FleetClient:
    """Producer-side handle: publish one rig's sensor frames from any
    process (live.LiveSource's publish API over shared memory)."""

    def __init__(self, name: str, rig: int, cfg: GridVisionConfig):
        self.cfg = cfg
        self._img = _image_box(name, rig, cfg, create=False)
        self._cloud = _cloud_box(name, rig, cfg, create=False)
        # points dropped by the capacity clamp: a LiDAR burst beyond the
        # mailbox's size degrades by subsampling, never by killing the
        # producer
        self.points_dropped = 0
        self.frames_clamped = 0

    def publish_image(self, rgb8: np.ndarray, stamp_ns: int = 0) -> None:
        self._img.write(
            np.ascontiguousarray(rgb8, np.uint8).tobytes(), stamp_ns)

    def publish_cloud(self, xyz: np.ndarray,
                      intensity: Optional[np.ndarray] = None,
                      stamp_ns: int = 0) -> None:
        """Publish one LiDAR scan (n, 3) [+ (n,) intensity]. A scan over
        the mailbox's capacity (from the server's shm header) is uniformly
        subsampled (even angular coverage: scans are angle-ordered) and
        counted in points_dropped / frames_clamped."""
        n = int(xyz.shape[0])
        cap_pts = max(int(self._cloud.capacity) // 16, 1)
        if n > cap_pts:
            keep = np.linspace(0, n - 1, cap_pts).round().astype(np.int64)
            xyz = xyz[keep]
            if intensity is not None:
                intensity = intensity[keep]
            self.points_dropped += n - cap_pts
            self.frames_clamped += 1
            n = cap_pts
        blob = np.zeros((n, 4), np.float32)
        blob[:, :3] = xyz
        if intensity is not None:
            blob[:, 3] = intensity
        self._cloud.write(blob.tobytes(), stamp_ns)

    def close(self) -> None:
        self._img.close()
        self._cloud.close()


class FleetServer:
    """Owns the card: polls every rig's mailboxes, steps the fleet, and
    publishes per-rig sessions."""

    def __init__(self, name: str, cfg: GridVisionConfig, n_rigs: int,
                 publish_every: int = 1, overlay: bool = False,
                 mesh: Optional[RigMesh] = None, shared: bool = False,
                 rig_extrinsics=None, chunk: int = 1,
                 track: bool = False, track_dt: float = 0.05,
                 tcfg=None, forecast_horizons=None):
        """shared=True runs a FUSION HUB: every rig's evidence merges into
        ONE world grid (parallel/shared_grid.py; rig_extrinsics: optional
        per-rig Extrinsics placing each sensor in the world) published as
        session "<name>-world"; otherwise each rig keeps its own grid and
        session (the fleet).

        chunk > 1 (shared only) runs K world ticks a call
        (SharedGrid.call_chunk): K-tick output latency.

        track=True (fleet only) runs the per-rig multi-object tracker
        (Fleet.tracked_step): each rig's session gains stable-id track
        markers (io/viz.track_markers), and .track_totals sums the
        tracker's telemetry. track_dt: the seconds between ticks the
        velocity model assumes (1 / hz of the spin).

        forecast_horizons (needs track=True): K horizons in seconds. At
        every publish each rig's session also carries predictive occupancy
        at t + h (Fleet.forecast: int8 probability x 100 planes on the grid
        raster, the session's 'forecast' channel).

        mesh: the rigs' shards (default: rig_mesh(), one a visible card;
        rig_mesh(device="cpu") runs on the CPU)."""
        self.name = name
        self.cfg = cfg
        self.n_rigs = n_rigs
        self.publish_every = publish_every
        self.shared = shared
        if chunk > 1 and not shared:
            raise ValueError("chunk>1 requires shared=True (the per-rig "
                             "fleet already scans internally)")
        if track and shared:
            raise ValueError("track=True requires fleet mode (the hub "
                             "publishes only the fused world grid)")
        if forecast_horizons and not track:
            raise ValueError("forecast_horizons requires track=True "
                             "(forecasts project tracked velocities)")
        self.chunk = max(int(chunk), 1)
        self.track = track
        mesh = mesh or rig_mesh()
        self.device = mesh.home
        self._obs_buf: List[Obs] = []
        if shared:
            from ..parallel.shared_grid import SharedGrid
            from ..types import Extrinsics
            self.grid = SharedGrid(cfg, n_rigs, mesh=mesh)
            self.world_lo = self.grid.init_grid()
            ext = rig_extrinsics or [Extrinsics.identity()] * n_rigs
            self._extr_b = stack([e.to(self.device) for e in ext])
            self._pubs = [SessionPublisher(f"{name}-world", cfg,
                                           overlay=False)]
            self.dropped_total = 0
            self._dropped_dev = torch.zeros((), dtype=torch.int32,
                                            device=self.device)
        else:
            self.fleet = Fleet(cfg, n_rigs, mesh=mesh)
            self.states = self.fleet.init_states()
            self._pubs = [SessionPublisher(rig_session(name, r), cfg,
                                           overlay=overlay)
                          for r in range(n_rigs)]
            if track:
                from ..ops.tracking import TrackConfig
                self.tcfg = tcfg or TrackConfig()
                self.track_dt = float(track_dt)
                self.tracks = self.fleet.init_tracks(self.tcfg)
                self.track_totals = {"matched": 0, "spawned": 0,
                                     "killed": 0, "spawn_dropped": 0}
            ex = self.fleet.extrinsics
            self._lidar_to_base = (ex.camera_to_base
                                   @ ex.lidar_to_camera).cpu().numpy()
        self.forecast_horizons = (tuple(float(h) for h in
                                        forecast_horizons)
                                  if forecast_horizons else None)
        self._img_boxes = [_image_box(name, r, cfg, create=True)
                           for r in range(n_rigs)]
        self._cloud_boxes = [_cloud_box(name, r, cfg, create=True)
                             for r in range(n_rigs)]
        h, w = cfg.camera_image_height, cfg.camera_image_width
        self._last_images = [np.zeros((h, w, 3), np.uint8)
                             for _ in range(n_rigs)]
        # each rig's last raw cloud (lidar frame), republished on the
        # session's cloudviz channel for the 3D operator view
        self._last_clouds: List[Optional[np.ndarray]] = [None] * n_rigs
        self.parse_errors = 0
        # the fleet's saturation telemetry (StepOutput.saturation summed
        # over rigs at every publish)
        self.saturation_totals = {
            "prenms_overflow": 0, "orientation_clamped": 0,
            "box_cloud_truncated": 0, "orientation_dropped": 0,
            "static_depth_clamped": 0}

    def poll_batch(self) -> Obs:
        """Latest-wins read of every rig's mailboxes -> a host Obs with a
        leading rig axis and uint8 frames. Stale frames are reused (the
        reference's member buffers); a sensor never seen gates through
        Q1. A malformed producer frame never stops the server: it is
        counted in parse_errors and the rig degrades as a silent sensor
        would."""
        cfg = self.cfg
        n = self.n_rigs
        h, w = cfg.camera_image_height, cfg.camera_image_width
        images = np.zeros((n, h, w, 3), np.uint8)
        xyz = np.full((n, cfg.max_points, 3), PointCloud.PAD_SENTINEL,
                      np.float32)
        inten = np.zeros((n, cfg.max_points), np.float32)
        counts = np.zeros((n,), np.int32)
        has_img = np.zeros((n,), bool)
        has_cloud = np.zeros((n,), bool)
        for r in range(n):
            frame = self._img_boxes[r].read()
            if frame is not None:
                data = frame[0]
                if len(data) == h * w * 3:
                    self._last_images[r] = np.frombuffer(
                        data, np.uint8).reshape(h, w, 3)
                    has_img[r] = True
                else:
                    self.parse_errors += 1
            images[r] = self._last_images[r]
            cframe = self._cloud_boxes[r].read()
            if cframe is not None:
                data = cframe[0]
                if len(data) % 16 == 0 and len(data) > 0:
                    x, i_, c = native.pack_cloud(data, len(data) // 16, 16,
                                                 0, 12, cfg.max_points)
                    xyz[r], inten[r], counts[r] = x, i_, c
                    has_cloud[r] = c > 0
                    if c > 0:
                        self._last_clouds[r] = np.array(x[:c])
                else:
                    self.parse_errors += 1
        t = torch.from_numpy
        return Obs(image=t(images),
                   cloud=PointCloud(xyz=t(xyz), intensity=t(inten),
                                    count=t(counts)),
                   has_image=t(has_img), has_cloud=t(has_cloud))

    def _lap(self, timings: Optional[dict], part: str, t0: float) -> float:
        """With a timings dict: the device synchronized, the ms since t0
        stored under `part`; returns the new mark."""
        if timings is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        timings[part] = (t - t0) * 1e3
        return t

    def step(self, i: int, timings: Optional[dict] = None) -> None:
        """One served tick. timings, when given, gets the tick's split in
        ms, the device synchronized at each boundary: poll_ms (the
        mailboxes into a host Obs), upload_ms (the Obs to the card),
        tick_ms (the engine), publish_ms (the outputs' readback and the
        sessions' publish; absent on a tick that does not publish)."""
        if self.shared:
            self._step_hub(i, timings)
            return
        t = time.perf_counter()
        obs = self.poll_batch()
        t = self._lap(timings, "poll_ms", t)
        obs = self.fleet.shard_obs(obs)
        t = self._lap(timings, "upload_ms", t)
        if self.track:
            self.states, self.tracks, outs, tstats = (
                self.fleet.tracked_step(self.states, self.tracks, obs,
                                        dt=self.track_dt, tcfg=self.tcfg))
        else:
            self.states, outs = self.fleet(self.states, obs)
        t = self._lap(timings, "tick_ms", t)
        if i % self.publish_every:
            return
        outs = outs.to("cpu")
        for k in self.saturation_totals:
            self.saturation_totals[k] += int(
                getattr(outs.saturation, k).sum())
        host_tracks = forecast_b = None
        if self.track:
            from ..io.viz import track_markers
            if self.forecast_horizons:
                forecast_b = self.fleet.forecast(
                    self.tracks, self.forecast_horizons,
                    self.tcfg).cpu().numpy()
            host_tracks = self.tracks.to("cpu")
            tstats = tstats.to("cpu")
            for k in self.track_totals:
                self.track_totals[k] += int(getattr(tstats, k).sum())
        for r in range(self.n_rigs):
            extra = (None if host_tracks is None else
                     track_markers(host_tracks.select(r), self.tcfg))
            cloud_r = None
            if self._last_clouds[r] is not None:
                pts = self._last_clouds[r]
                if pts.shape[0] > CLOUDVIZ_MAX_POINTS:
                    keep = np.linspace(0, pts.shape[0] - 1,
                                       CLOUDVIZ_MAX_POINTS
                                       ).round().astype(np.int64)
                    pts = pts[keep]
                # lidar -> base frame for the world-frame 3D view
                l2b = self._lidar_to_base
                cloud_r = pts @ l2b[:3, :3].T + l2b[:3, 3]
            self._pubs[r].publish(
                i, outs.select(r), image=self._last_images[r],
                extra_markers=extra,
                forecast=None if forecast_b is None else forecast_b[r],
                horizons=self.forecast_horizons, cloud_xyz=cloud_r)
        self._lap(timings, "publish_ms", t)

    def _step_hub(self, i: int, timings: Optional[dict]) -> None:
        t = time.perf_counter()
        obs = self.poll_batch()
        t = self._lap(timings, "poll_ms", t)
        obs = obs.to(self.device)
        t = self._lap(timings, "upload_ms", t)
        key = prng.prng_key(i, device=self.device)
        if self.chunk > 1:
            self._obs_buf.append(obs)
            if len(self._obs_buf) < self.chunk:
                return
            obs_c = stack(self._obs_buf)
            self._obs_buf.clear()
            self.world_lo, occ_c, dropped = self.grid.call_chunk(
                self.world_lo, obs_c, self._extr_b, key)
            # every tick's grid is computed; the publish shows the newest
            occ = occ_c[-1]
        else:
            self.world_lo, occ, dropped = self.grid(
                self.world_lo, obs, self._extr_b, key)
        # summed on the card; read back at the publish cadence only
        self._dropped_dev = self._dropped_dev + dropped
        t = self._lap(timings, "tick_ms", t)
        if i % self.publish_every == 0:
            self.dropped_total = int(self._dropped_dev)
            self._pubs[0].publish(i, _grid_only_output(occ, self.cfg))
            self._lap(timings, "publish_ms", t)

    def spin(self, steps: Optional[int] = None, hz: float = 20.0,
             stop: Optional[threading.Event] = None) -> int:
        period = 1.0 / hz
        i = 0
        t0 = time.perf_counter()
        while steps is None or i < steps:
            if stop is not None and stop.is_set():
                break
            self.step(i)
            i += 1
            sleep = t0 + i * period - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
        return i

    def close(self, unlink: bool = True) -> None:
        for b in self._img_boxes + self._cloud_boxes:
            if unlink:
                b.unlink()     # the server created them
            b.close()
        for p in self._pubs:
            if unlink:
                p.unlink()
            p.close()


def _grid_only_output(occupancy: torch.Tensor,
                      cfg: GridVisionConfig) -> StepOutput:
    """A host StepOutput carrying just the fused world grid (the hub's
    session has no single rig's boxes or poses to publish)."""
    from ..ops.rasterize import export_occupancy_i8
    zero = torch.zeros((), dtype=torch.int32)
    return StepOutput(
        boxes=Boxes.empty(cfg.max_detections),
        poses=LShapePoses.empty(cfg.max_orientation_batch),
        static_points=torch.zeros((cfg.max_detections, 3)),
        static_depths=torch.full((cfg.max_detections,), -1.0),
        static_boxes=Boxes.empty(cfg.max_detections),
        occupancy_i8=export_occupancy_i8(occupancy).cpu(),
        saturation=SaturationStats(
            prenms_overflow=zero, orientation_clamped=zero,
            box_cloud_truncated=zero, orientation_dropped=zero,
            static_depth_clamped=zero))


def selftest_producers(name: str, cfg: GridVisionConfig, n_rigs: int,
                       hz: float, stop: threading.Event
                       ) -> List[threading.Thread]:
    """One synthetic-scene producer thread a rig (the demo / test feed)."""

    def produce(rig: int):
        scene = SyntheticScene(cfg, seed=rig)
        scene.add_default_traffic()
        client = FleetClient(name, rig, cfg)
        t0 = time.perf_counter()
        while not stop.is_set():
            t = time.perf_counter() - t0
            client.publish_image(
                np.clip(scene.image_at(t), 0, 255).astype(np.uint8))
            client.publish_cloud(scene.cloud_at(t))
            time.sleep(1.0 / hz)
        client.close()

    threads = [threading.Thread(target=produce, args=(r,), daemon=True)
               for r in range(n_rigs)]
    for th in threads:
        th.start()
    return threads


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="grid_vision_tpu_torch serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--name", default="fleet")
    ap.add_argument("--rigs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--hz", type=float, default=20.0)
    ap.add_argument("--publish-every", type=int, default=1)
    ap.add_argument("--config", default=None)
    ap.add_argument("--selftest", action="store_true",
                    help="feed every rig from an in-process synthetic "
                         "scene producer thread")
    ap.add_argument("--shared", action="store_true",
                    help="fusion-hub mode: all rigs merge into ONE "
                         "world grid (session NAME-world)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="shared mode: K world ticks a call (K-tick "
                         "output latency)")
    ap.add_argument("--track", action="store_true",
                    help="fleet mode: run the per-rig multi-object "
                         "tracker after each tick; sessions gain "
                         "stable-id track markers")
    ap.add_argument("--forecast", default=None, metavar="H1,H2,...",
                    help="with --track: publish predictive occupancy "
                         "at these horizons (seconds, e.g. 0.5,1,2) on "
                         "each rig's 'forecast' channel")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from ..config import load_config
    cfg = (load_config(args.config) if args.config
           else GridVisionConfig())
    if args.track:
        # tracking needs real detections: the shipped checkpoints where
        # the config names none (run --track's rule)
        w = {}
        if not cfg.detection_weights_file and os.path.exists(
                "weights/detector.npz"):
            w["detection_weights_file"] = "weights/detector.npz"
        if (cfg.use_vision_orientation and not cfg.vision_weights_file
                and os.path.exists("weights/orientation.npz")):
            w["vision_weights_file"] = "weights/orientation.npz"
        if w:
            cfg = dataclasses.replace(cfg, **w)
    horizons = (tuple(float(h) for h in args.forecast.split(","))
                if args.forecast else None)
    server = FleetServer(args.name, cfg, args.rigs,
                         publish_every=args.publish_every,
                         shared=args.shared, chunk=args.chunk,
                         track=args.track, track_dt=1.0 / args.hz,
                         forecast_horizons=horizons,
                         mesh=rig_mesh(device="cpu" if args.cpu
                                       else "cuda"))
    stop = threading.Event()
    if args.selftest:
        selftest_producers(args.name, cfg, args.rigs, args.hz, stop)
    view_session = (f"{args.name}-world" if args.shared
                    else rig_session(args.name, 0))
    print(f"serving {'fusion hub' if args.shared else 'fleet'} "
          f"{args.name!r}: {args.rigs} rigs at {args.hz:.0f} Hz on "
          f"{server.device} (view: python -m grid_vision_tpu view "
          f"--session {view_session})", flush=True)
    try:
        n = server.spin(steps=args.steps, hz=args.hz)
        print(f"served {n} fleet steps", flush=True)
        if args.track:
            t = server.track_totals
            print(f"tracker: matched {t['matched']} spawned "
                  f"{t['spawned']} killed {t['killed']} "
                  f"spawn_dropped {t['spawn_dropped']}", flush=True)
    finally:
        stop.set()
        server.close()


if __name__ == "__main__":
    main()
