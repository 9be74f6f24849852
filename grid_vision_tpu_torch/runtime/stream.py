"""Streaming replay: the 10 Hz sequence harness (counterpart of
grid_vision_tpu/runtime/stream.py), and the fleet scene pool of bench.py
(build_obs_pool, which imports JAX).

Replaces the reference's 50 ms wall timer + DDS ingest loop
(src/grid_vision_node.cpp:49-50, 79-106) with a host loop that renders
frames of a SyntheticScene in worker threads, packs each into the
single-buffer wire (types.Obs.pack_bytes; or the ROI-delta wire), steps
the engine on the packed buffer (Engine.call_packed: one host->device
copy a frame) and records per-step host timings (utils/stats.StepStats).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import GridVisionConfig
from ..device import resolve_device
from ..io.scene import SyntheticScene
from ..pipeline import Engine
from ..types import (GridState, Obs, PointCloud, delta_roi_shape,
                     pack_delta_bytes, stack)
from ..utils.stats import StepStats


def obs_from_scene(scene: SyntheticScene, t: float, cfg: GridVisionConfig,
                   device="cuda") -> Obs:
    """The scene's frame and cloud at time t as an Obs on `device` (the
    card unless the CPU is asked for)."""
    return obs_from_scene_with_stats(scene, t, cfg, device)[0]


class FleetPool:
    """One traffic scene per rig, as bench.build_obs_pool builds them: rig
    r is SyntheticScene(seed=r, n_ground=max_points // 2) with the default
    traffic and statics, 0-2 extra cars drawn from default_rng(1000 + r),
    seen at a time t_r drawn from the same generator in [0, 2). Tick i
    shows every rig at t_r + 0.1 i (tick 0 is bench's pool).

    image_dtype: the frames' storage dtype (bench.build_obs_pool's; bf16 in
    the production configuration: 8-bit pixels are exact in bf16)."""

    def __init__(self, cfg: GridVisionConfig, n_rigs: int, device="cuda",
                 image_dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.image_dtype = image_dtype
        self.scenes, self.t0 = [], []
        for r in range(n_rigs):
            scene = SyntheticScene(cfg, seed=r, n_ground=cfg.max_points // 2)
            scene.add_default_traffic()
            scene.add_default_statics()
            rng = np.random.default_rng(1000 + r)
            for _ in range(int(rng.integers(0, 3))):
                scene.add_object(
                    center=[rng.uniform(-4, 4), 1.2, rng.uniform(8, 35)],
                    velocity=[rng.uniform(-1, 1), 0.0, rng.uniform(-3, 1)],
                    size=(1.8, 1.4, 4.2), label=9)
            self.scenes.append(scene)
            self.t0.append(float(rng.uniform(0.0, 2.0)))

    def obs(self, tick: int = 0) -> Obs:
        """The fleet's Obs at tick `tick`, leading rig axis, on the pool's
        device (rendered on the host, then one copy per field)."""
        host = stack([obs_from_scene(s, t + 0.1 * tick, self.cfg, "cpu")
                      for s, t in zip(self.scenes, self.t0)])
        host = dataclasses.replace(host,
                                   image=host.image.to(self.image_dtype))
        return host.to(self.device)


def _finish(state: GridState) -> None:
    """Wait for the device: one scalar readback of the carried grid."""
    state.log_odds.reshape(-1)[0].item()


def obs_from_scene_with_stats(scene: SyntheticScene, t: float,
                              cfg: GridVisionConfig, device="cuda"):
    """obs_from_scene + host-side ingest telemetry: the number of finite
    cloud points dropped by the capacity subsample
    (types.PointCloud.pack_host). Returns (Obs, dropped)."""
    device = resolve_device(device)
    cloud, dropped = PointCloud.pack_numpy(scene.cloud_at(t), None,
                                           cfg.max_points, device=device)
    return Obs(image=torch.as_tensor(scene.image_at(t), device=device),
               cloud=cloud,
               has_image=torch.tensor(True, device=device),
               has_cloud=torch.tensor(True, device=device)), dropped


@dataclasses.dataclass
class ReplayResult:
    n_steps: int
    wall_s: float
    stats: List[StepStats]
    final_state: GridState

    @property
    def achieved_hz(self) -> float:
        return self.n_steps / self.wall_s if self.wall_s > 0 else 0.0


def _scene_frame(scene: SyntheticScene, t: float, cfg: GridVisionConfig):
    """The scene at t for the wire: (uint8 frame, packed xyz, packed
    intensity, count, dropped), all host numpy."""
    xyz, inten, n, dropped = PointCloud.pack_host(scene.cloud_at(t), None,
                                                  cfg.max_points)
    img = np.clip(scene.image_at(t), 0, 255).astype(np.uint8)
    return img, xyz, inten, n, dropped


def packed_from_scene(scene: SyntheticScene, t: float,
                      cfg: GridVisionConfig):
    """Render + pack one observation into the single-transfer wire buffer
    (types.Obs.pack_bytes). Returns (np.uint8 buffer, dropped)."""
    img, xyz, inten, n, dropped = _scene_frame(scene, t, cfg)
    return Obs.pack_bytes(img, xyz, inten, n, True, n > 0, cfg), dropped


class PackedDeltaEncoder:
    """Host-side ROI-delta wire encoder (types.pack_delta_bytes), the JAX
    package's encoder: the same frames give the same keyframe / delta
    sequence and the same bytes.

    encode() diffs the new frame against the DECODER-VISIBLE
    reconstruction (the carried previous frame with only the emitted ROIs
    patched in, exactly what types.unpack_delta holds on the device); if
    every changed pixel fits the fixed ROI window (types.delta_roi_shape)
    it emits a delta record (~4x fewer image bytes), otherwise a keyframe
    (the full Obs.pack_bytes buffer). The first frame is always a
    keyframe, and one is forced every `keyframe_interval` records so the
    sub-threshold residual (bounded at `threshold` grey levels a pixel by
    the reconstruction diff, never accumulating) is periodically squashed
    to zero. Pixel changes below `threshold` grey levels count as static.

    Encoding is sequential: each record's diff depends on what the decoder
    reconstructed from all prior records. Encode in frame order on one
    thread (prefetch workers render frames; the consumer loop encodes)."""

    def __init__(self, cfg: GridVisionConfig, threshold: int = 2,
                 keyframe_interval: int = 64):
        if cfg.wire_image_codec != "rgb8":
            raise ValueError("ROI-delta wire requires "
                             "wire_image_codec='rgb8'")
        self.cfg = cfg
        self.threshold = threshold
        self.keyframe_interval = keyframe_interval
        self.roi_h, self.roi_w = delta_roi_shape(cfg)
        self._recon: Optional[np.ndarray] = None
        self._since_key = 0
        self.keyframes = 0
        self.deltas = 0

    def encode(self, img_u8: np.ndarray, xyz: np.ndarray,
               inten: np.ndarray, count: int, has_image: bool,
               has_cloud: bool):
        """Encode one frame against the decoder-visible reconstruction.
        -> (keyframe: bool, buf)."""
        cfg = self.cfg
        img_u8 = np.ascontiguousarray(img_u8, np.uint8)
        fits = False
        y0 = x0 = 0
        due = (self._recon is None
               or self._since_key >= self.keyframe_interval)
        if not due:
            diff = np.abs(img_u8.astype(np.int16)
                          - self._recon.astype(np.int16)).max(axis=-1)
            ys, xs = np.nonzero(diff > self.threshold)
            if ys.size == 0:
                y0 = x0 = 0
                fits = True
            elif (ys.max() - ys.min() < self.roi_h
                    and xs.max() - xs.min() < self.roi_w):
                # clamp the window inside the frame
                y0 = min(int(ys.min()), img_u8.shape[0] - self.roi_h)
                x0 = min(int(xs.min()), img_u8.shape[1] - self.roi_w)
                fits = True
        if fits:
            roi = img_u8[y0:y0 + self.roi_h, x0:x0 + self.roi_w]
            # mirror the device decoder: patch ONLY the ROI into the
            # carried reconstruction (types.unpack_delta)
            self._recon[y0:y0 + self.roi_h, x0:x0 + self.roi_w] = roi
            self._since_key += 1
            self.deltas += 1
            return False, pack_delta_bytes(roi, y0, x0, xyz, inten,
                                           count, has_image, has_cloud,
                                           cfg)
        self._recon = img_u8.copy()
        self._since_key = 0
        self.keyframes += 1
        return True, Obs.pack_bytes(img_u8, xyz, inten, count,
                                    has_image, has_cloud, cfg)


def replay_delta(engine: Engine, scene: SyntheticScene, n_steps: int,
                 hz: float = 10.0, prefetch: int = 8,
                 workers: int = 2) -> ReplayResult:
    """Per-frame replay over the ROI-delta wire (Engine.call_packed_delta):
    the outputs of `replay` (every frame published, one step a frame)
    with ~4x fewer image bytes a delta record. Prefetch workers render
    frames; the consumer loop runs the sequential encoder. The result
    carries the encoder (its keyframe / delta counters) as
    `delta_encoder`."""
    cfg = engine.cfg
    period = 1.0 / hz
    enc = PackedDeltaEncoder(cfg)
    state = engine.init_state()
    prev = torch.zeros((cfg.camera_image_height, cfg.camera_image_width, 3),
                       dtype=torch.uint8, device=engine.device)
    stats: List[StepStats] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {i: pool.submit(_scene_frame, scene, i * period, cfg)
                   for i in range(min(prefetch, n_steps))}
        t_start = time.perf_counter()
        for i in range(n_steps):
            img, ox, oi, n, dropped = futures.pop(i).result()
            key, buf = enc.encode(img, ox, oi, n, True, n > 0)
            j = i + prefetch
            if j < n_steps:
                futures[j] = pool.submit(_scene_frame, scene, j * period,
                                         cfg)
            t0 = time.perf_counter()
            state, prev, _out = engine.call_packed_delta(state, prev, buf,
                                                         keyframe=key)
            stats.append(StepStats(step=i,
                                   dispatch_s=time.perf_counter() - t0,
                                   cloud_points_dropped=dropped))
        _finish(state)
        wall = time.perf_counter() - t_start
    res = ReplayResult(n_steps=n_steps, wall_s=wall, stats=stats,
                       final_state=state)
    res.delta_encoder = enc
    return res


def replay_chunked(engine: Engine, scene: SyntheticScene, n_steps: int,
                   hz: float = 10.0, chunk: int = 8, prefetch: int = 4,
                   workers: int = 2) -> ReplayResult:
    """Throughput-mode sequence replay: K packed frames a transfer, K steps
    a call (Engine.call_packed_chunk). For a latency-bound host link where
    K frames of output delay are acceptable; `replay` (per frame) is the
    realtime-capable path."""
    cfg = engine.cfg
    period = 1.0 / hz
    n_chunks = max(n_steps // chunk, 1)

    def gen(ci: int):
        return np.stack([
            packed_from_scene(scene, (ci * chunk + j) * period, cfg)[0]
            for j in range(chunk)])

    state = engine.init_state()
    stats: List[StepStats] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {i: pool.submit(gen, i)
                   for i in range(min(prefetch, n_chunks))}
        t_start = time.perf_counter()
        for i in range(n_chunks):
            buf = futures.pop(i).result()
            j = i + prefetch
            if j < n_chunks:
                futures[j] = pool.submit(gen, j)
            t0 = time.perf_counter()
            state, _outs = engine.call_packed_chunk(state, buf)
            stats.append(StepStats(
                step=i * chunk, dispatch_s=time.perf_counter() - t0,
                cloud_points_dropped=0))
        _finish(state)
        wall = time.perf_counter() - t_start
    return ReplayResult(n_steps=n_chunks * chunk, wall_s=wall,
                        stats=stats, final_state=state)


def replay_ring(engine: Engine, scene: SyntheticScene, n_steps: int,
                hz: float = 10.0, chunk: int = 8,
                ring: int = 64) -> ReplayResult:
    """Ingest-rate measurement: pre-pack `ring` frames, then stream
    `n_steps` frames from the ring through the chunked packed path.

    This isolates what the ENGINE can ingest (host->device copy, unpack
    and the tick) from the cost of synthesizing the frames: a deployed rig
    receives its frames from hardware. `replay` / `replay_chunked` include
    the synthetic renderer and under-report ingest whenever rendering is
    slower than the device."""
    cfg = engine.cfg
    period = 1.0 / hz
    ring = max(ring, chunk)
    bufs = np.stack([packed_from_scene(scene, i * period, cfg)[0]
                     for i in range(ring)])
    n_chunks = max(n_steps // chunk, 1)
    state = engine.init_state()
    t_start = time.perf_counter()
    for i in range(n_chunks):
        lo = (i * chunk) % (ring - chunk + 1)
        state, _outs = engine.call_packed_chunk(state, bufs[lo:lo + chunk])
    _finish(state)
    wall = time.perf_counter() - t_start
    return ReplayResult(n_steps=n_chunks * chunk, wall_s=wall, stats=[],
                        final_state=state)


def replay(engine: Engine, scene: SyntheticScene, n_steps: int,
           hz: float = 10.0, realtime: bool = False,
           on_step: Optional[Callable] = None,
           prefetch: int = 8, packed: bool = True,
           workers: int = 2) -> ReplayResult:
    """Run a temporal sequence through the engine.

    realtime=False free-runs (throughput mode); realtime=True paces the
    loop at `hz` like the reference's wall timer.

    packed=True (default) streams each frame as ONE uint8 wire buffer
    (Engine.call_packed: one host->device copy); the worker pool keeps `prefetch`
    frames rendering while the device runs, and the launches of a tick
    are asynchronous. packed=False keeps the typed-Obs path (the frames
    made on the engine's device by the workers)."""
    cfg = engine.cfg
    state = engine.init_state()
    period = 1.0 / hz
    if packed:
        gen, call = packed_from_scene, engine.call_packed
    else:
        gen = functools.partial(obs_from_scene_with_stats,
                                device=engine.device)
        call = engine

    stats: List[StepStats] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {i: pool.submit(gen, scene, i * period, cfg)
                   for i in range(min(prefetch, n_steps))}
        t_start = time.perf_counter()
        for i in range(n_steps):
            obs, cloud_dropped = futures.pop(i).result()
            j = i + prefetch
            if j < n_steps:
                futures[j] = pool.submit(gen, scene, j * period, cfg)
            t0 = time.perf_counter()
            state, out = call(state, obs)
            t_dispatch = time.perf_counter() - t0
            if on_step is not None:
                on_step(i, state, out)
            stats.append(StepStats(step=i, dispatch_s=t_dispatch,
                                   cloud_points_dropped=cloud_dropped))
            if realtime:
                sleep = (i + 1) * period - (time.perf_counter() - t_start)
                if sleep > 0:
                    time.sleep(sleep)
        _finish(state)
        wall = time.perf_counter() - t_start
    return ReplayResult(n_steps=n_steps, wall_s=wall, stats=stats,
                        final_state=state)


# ---------------------------------------------------------------------------
# adaptive wire selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WirePlan:
    """The adaptive gate's decision record for one link + workload.

    The ROI-delta wire trades host encoder time (diff + pack a frame) for
    wire bytes. On a fast link the bytes don't bind and the encoder time
    is pure loss; on a slow link the bytes dominate and delta wins. The
    closed-form crossover:

        delta wins  <=>  (bytes_full - bytes_delta) / bw  >  encode_s
                    <=>  bw  <  (bytes_full - bytes_delta) / encode_s

    where bytes_delta is the keyframe-mix expectation measured on real
    frames of THIS scene (the ROI only fits when the frame-to-frame change
    is localized)."""

    mode: str                     # "delta" | "full"
    link_bw_bytes_s: float        # measured (probe_link_bandwidth)
    bytes_full: int               # one full packed frame on this cfg
    bytes_delta_expected: float   # keyframe-mix expectation
    keyframe_frac: float
    encode_s: float               # host encoder seconds per frame
    crossover_bw_bytes_s: float   # below this bandwidth, delta wins
    est_hz_full: float            # transfer-bound estimates (device
    est_hz_delta: float           # compute overlaps)


def probe_link_bandwidth(device="cuda", reps: int = 5, big: int = 8 << 20,
                         small: int = 1 << 12) -> float:
    """Host->device link bandwidth (bytes/s) of `device` (the card unless
    the CPU is asked for), from pageable host memory, as the engine
    copies.

    Two-size probe: timing one transfer measures bandwidth + the fixed
    per-copy latency; timing two sizes and differencing cancels the
    latency. Each probe waits for the device; the median over reps resists
    outliers."""
    device = resolve_device(device)

    def t_of(nbytes: int) -> float:
        buf = torch.ones(nbytes, dtype=torch.uint8)
        ts = []
        for _ in range(reps + 1):        # the first copy warms up
            t0 = time.perf_counter()
            dev = buf.to(device)
            dev[-1:].sum().item()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts[1:]))

    t_big, t_small = t_of(big), t_of(small)
    return max(float(big - small) / max(t_big - t_small, 1e-6), 1.0)


def plan_wire(cfg: GridVisionConfig, scene: SyntheticScene,
              link_bw_bytes_s: float, sample: int = 16,
              hz: float = 10.0) -> WirePlan:
    """Choose full-frame vs ROI-delta wire for this link and scene.

    Runs the real encoder over `sample` rendered frames to measure its
    host cost and the expected keyframe / delta byte mix (both depend on
    the content), then applies the closed-form crossover above. Host work
    only. A non-rgb8 wire codec has no delta encoder: the plan is 'full'
    with a zero crossover."""
    period = 1.0 / hz
    if cfg.wire_image_codec != "rgb8":
        img, ox, oi, n, _ = _scene_frame(scene, 0.0, cfg)
        bytes_full = len(Obs.pack_bytes(img, ox, oi, n, True, n > 0, cfg))
        return WirePlan(
            mode="full", link_bw_bytes_s=float(link_bw_bytes_s),
            bytes_full=int(bytes_full),
            bytes_delta_expected=float(bytes_full), keyframe_frac=1.0,
            encode_s=0.0, crossover_bw_bytes_s=0.0,
            est_hz_full=float(link_bw_bytes_s) / bytes_full,
            est_hz_delta=float(link_bw_bytes_s) / bytes_full)
    enc = PackedDeltaEncoder(cfg)
    total_bytes = 0.0
    t_enc = 0.0
    bytes_full = None
    for i in range(sample):
        img, ox, oi, n, _ = _scene_frame(scene, i * period, cfg)
        if bytes_full is None:
            bytes_full = len(
                Obs.pack_bytes(img, ox, oi, n, True, n > 0, cfg))
        t0 = time.perf_counter()
        _key, buf = enc.encode(img, ox, oi, n, True, n > 0)
        t_enc += time.perf_counter() - t0
        total_bytes += len(buf)
    encode_s = t_enc / sample
    bytes_delta = total_bytes / sample
    kf = enc.keyframes / max(enc.keyframes + enc.deltas, 1)
    saved = max(float(bytes_full) - bytes_delta, 0.0)
    crossover = saved / max(encode_s, 1e-9)
    est_full = 1.0 / max(bytes_full / link_bw_bytes_s, 1e-9)
    est_delta = 1.0 / max(bytes_delta / link_bw_bytes_s + encode_s, 1e-9)
    return WirePlan(
        mode="delta" if link_bw_bytes_s < crossover else "full",
        link_bw_bytes_s=float(link_bw_bytes_s),
        bytes_full=int(bytes_full),
        bytes_delta_expected=float(bytes_delta),
        keyframe_frac=float(kf),
        encode_s=float(encode_s),
        crossover_bw_bytes_s=float(crossover),
        est_hz_full=float(est_full),
        est_hz_delta=float(est_delta),
    )


def replay_auto(engine: Engine, scene: SyntheticScene, n_steps: int,
                hz: float = 10.0, link_bw_bytes_s: float | None = None,
                **kw):
    """Per-frame replay with the wire chosen by plan_wire.

    Probes the engine's link unless a bandwidth is given, plans against
    THIS scene's content, then runs replay (full frames) or replay_delta
    (ROI-delta records). Returns (plan, ReplayResult)."""
    if link_bw_bytes_s is None:
        link_bw_bytes_s = probe_link_bandwidth(engine.device)
    plan = plan_wire(engine.cfg, scene, link_bw_bytes_s, hz=hz)
    if plan.mode == "delta":
        res = replay_delta(engine, scene, n_steps, hz=hz, **kw)
    else:
        res = replay(engine, scene, n_steps, hz=hz, **kw)
    return plan, res
