"""The harness: one run of one cell.

A cell (BENCHMARK.json's `workloads`) names a configuration (configs/,
the engine's settings and the peak its shares are taken against) and a
traffic mix (traffic/<name>.json: rigs, loop, chunk, the ticks judged and
traced); its limits sit in limits/<cell>.json and each metric's reader in
metrics/<metric>.py. A configuration may name its detector's plain
reference, a module under detectors/ (its "detector" key; detector()). A
later cell, mix, metric or detector is a new file.

A run: render the rigs' scenes from the seed (scene.py), build the
system under test (the program's Engine, or the reference in a lower
precision as the control), warm up the cell's shapes, then for `seconds`
drive fleet ticks on the card, each on the pool perturbed by a brightness
offset and a point jitter drawn on the card from the seed:

  ahead  chunks of `chunk` ticks, one readback of the chunk's counters
  tick   a closed loop: each tick's published outputs (the int8 grid,
         boxes, poses, static points, counters) copied to the host
         before the next tick is sent; with the mix's rate_hz an open
         loop, each tick sent when it is due

A reservoir drawn from the seed keeps a few window ticks (and in a
closed loop the slowest) with their inputs, the grid before them and
their outputs; once the window has closed and the program is freed,
judge.py compares them with the reference.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import time
import types

import numpy as np

from . import counts, reference, scene
from . import judge as judge_mod
from . import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "grid_vision_tpu")
# what a published tick carries to the host (runtime/serve.py's publish)
PUBLISHED = ("occupancy_i8", "static_points", "boxes.xyxy",
             "boxes.confidence", "boxes.label", "boxes.valid",
             "poses.position", "poses.quat", "poses.length", "poses.width",
             "poses.height", "poses.label", "poses.valid",
             "saturation.prenms_overflow", "saturation.orientation_clamped",
             "saturation.box_cloud_truncated",
             "saturation.orientation_dropped",
             "saturation.static_depth_clamped")


def forbidden_modules(names) -> list:
    """The forbidden top-level packages among module names, each compared
    whole by its part before the first dot."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, at its
    clock tick, against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT):
    """(manifest, cell entry, configuration, traffic, limits) by name."""
    manifest = _json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return (manifest, cell, _json(root, entry["file"]),
            _json(HERE, "traffic", f"{cell['traffic']}.json"),
            _json(HERE, "limits", f"{workload}.json"))


def metrics_of(manifest, workload: str, kind: str) -> list:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """metrics/<name>.py's read(rec)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- detector

# a configuration without a "detector": YOLOv4-tiny in float
_TINY = types.SimpleNamespace(detect_dense=reference.detect_dense,
                              detector_ops=counts.detector_ops)


def detector(config: dict):
    """The configuration's detector reference: detect_dense(nets, images,
    size) -> (boxes (B, A, 4) normalized xyxy, confs (B, A, C)), rounding
    as nets.mode says; detector_ops(size), model operations a frame;
    optionally control(mode) -> (detect_dense, reference.Nets's mode),
    the detector and rounding a Control mode stands for. The module file
    that "detector" names (it imports nothing of the program), or without
    the key YOLOv4-tiny in float: reference.detect_dense and
    counts.detector_ops."""
    path = config.get("detector")
    if path is None:
        return _TINY
    return _detector_module(os.path.join(ROOT, path))


@functools.lru_cache(maxsize=None)
def _detector_module(path: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        f"benchmark_detector_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- traffic

def build_pool(torch, config: dict, traffic: dict, seed: int, device):
    """The rigs' scenes on the device: image (R, H, W, 3) in the
    configuration's frame dtype, xyz (R, P, 3), count (R,)."""
    eng = config["engine"]
    t = time.perf_counter()
    images, xyz, count = scene.render_pool(
        eng, eng["max_points"], *scene.rig_seeds(seed, traffic["rigs"]))
    render_s = time.perf_counter() - t
    dtype = getattr(torch, config["image_dtype"])
    return types.SimpleNamespace(
        image=torch.from_numpy(images).to(device).to(dtype),
        xyz=torch.from_numpy(xyz).to(device),
        count=torch.from_numpy(count).to(device)), render_s


def draw(torch, gen, n_ticks: int, n_rigs: int, device):
    """A chunk's perturbations: brightness (T, R, 1, 1, 1) in [-8, 8),
    jitter (T, R, 1, 3) in [-0.03, 0.03) metres."""
    bright = torch.rand((n_ticks, n_rigs, 1, 1, 1), generator=gen,
                        device=device) * 16.0 - 8.0
    jitter = torch.rand((n_ticks, n_rigs, 1, 3), generator=gen,
                        device=device) * 0.06 - 0.03
    return bright, jitter


def perturbed(pool, bright, jitter):
    """One tick's observation: the brightness cast to the frames' dtype and
    added, the jitter added to every point."""
    return types.SimpleNamespace(image=pool.image + bright.to(
        pool.image.dtype), xyz=pool.xyz + jitter, count=pool.count)


# ---------------------------------------------------------------- systems

class Program:
    """The system under test: grid_vision_tpu_torch's Engine.fleet with
    the configuration's orientation budget."""

    def __init__(self, torch, config: dict, n_rigs: int, device):
        from grid_vision_tpu_torch import pipeline
        from grid_vision_tpu_torch.config import GridVisionConfig
        from grid_vision_tpu_torch.types import Obs, PointCloud
        self.torch, self._obs, self._cloud = torch, Obs, PointCloud
        self.engine = pipeline.Engine(GridVisionConfig(**config["engine"]),
                                      device=device, base_dir=ROOT)
        eye = torch.eye(4, device=device)
        ext = self.engine.extrinsics
        if not (torch.equal(ext.lidar_to_camera, eye)
                and torch.equal(ext.camera_to_base, eye)):
            raise ValueError("the benchmark's rigs have identity extrinsics")
        self.budget = config["orientation_budget_per_rig"] * n_rigs
        self.intensity = torch.zeros((n_rigs, config["engine"]["max_points"]),
                                     device=device)
        self.has = torch.ones((n_rigs,), dtype=torch.bool, device=device)

    def init_states(self, n: int):
        return self.engine.init_states(n)

    def step(self, states, obs):
        o = self._obs(image=obs.image,
                      cloud=self._cloud(xyz=obs.xyz, intensity=self.intensity,
                                        count=obs.count),
                      has_image=self.has, has_cloud=self.has)
        return self.engine.fleet(states, o, self.budget)


class Control:
    """The reference in the program's place, its nets in `mode` ("tf32",
    "fp8"; reference.py), or in a mode that the configuration's detector
    module maps to its detector and rounding (its control()): the control
    that `correct` has to refuse."""

    def __init__(self, torch, config: dict, n_rigs: int, device, mode: str):
        reference.ieee()
        self.torch, self.c = torch, config["engine"]
        det = detector(config)
        self.detect, rounding = (det.control(mode) if hasattr(det, "control")
                                 else (det.detect_dense, mode))
        self.nets = weights(config, device, rounding)
        self.budget = config["orientation_budget_per_rig"] * n_rigs
        self.eye = torch.eye(4, device=device)
        self.device = device

    def init_states(self, n: int):
        h = int(round(self.c["grid_x"] / self.c["resolution"]))
        w = int(round(self.c["grid_y"] / self.c["resolution"]))
        return types.SimpleNamespace(
            log_odds=self.torch.full((n, h, w), self.c["log_odds_prior"],
                                     device=self.device),
            occupancy=self.torch.full((n, h, w), self.c["init_probability"],
                                      device=self.device))

    def step(self, states, obs):
        with self.torch.no_grad():
            return reference.fleet_tick(self.nets, states, obs, self.c,
                                        self.budget, self.eye, self.eye,
                                        self.detect)


def weights(config: dict, device, mode: str = "f32"):
    eng = config["engine"]
    return reference.Nets(os.path.join(ROOT, eng["detection_weights_file"]),
                          os.path.join(ROOT, eng["vision_weights_file"]),
                          device, mode)


def _field(out, path: str):
    for part in path.split("."):
        out = getattr(out, part)
    return out


def tick_counts(torch, out):
    """(boxes, crops run, crops dropped by the budget) of a tick, summed
    over the rigs, as one small tensor on the outputs' device."""
    return torch.stack([out.boxes.valid.sum(), out.poses.valid.sum(),
                        out.saturation.orientation_dropped.sum()])


# ---------------------------------------------------------------- the run

class Sampler:
    """A reservoir of `k` window ticks drawn by `rng`, and with keep_slowest
    the tick of the longest latency besides."""

    def __init__(self, k: int, rng, keep_slowest: bool):
        self.k, self.rng, self.keep_slowest = k, rng, keep_slowest
        self.items, self.n, self.slowest = [], 0, None

    def offer(self, item, latency=None):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.n))
            if j < self.k:
                self.items[j] = item
        if self.keep_slowest and latency is not None and (
                self.slowest is None or latency > self.slowest[0]):
            self.slowest = (latency, item)

    def samples(self) -> list:
        out = list(self.items)
        if self.slowest is not None and all(
                s is not self.slowest[1] for s in out):
            out.append(self.slowest[1])
        return out


def drive(torch, system, pool, states, traffic, gen, device, sync,
          stop, sampler=None, hold=None):
    """Ticks in the traffic's loop until stop(elapsed) after a readback.
    A "tick" loop with rate_hz is an open loop: tick i is due rate_hz * i
    seconds after the start and its latency runs from when it was due;
    without, each tick is sent when the last one's outputs are in.
    Returns (states, tick records, seconds from the first draw to the
    last readback)."""
    n_rigs, chunk = traffic["rigs"], traffic["chunk"]
    closed = traffic["loop"] == "tick"
    rate = traffic.get("rate_hz") if closed else None
    clock = time.perf_counter
    ticks = []
    t_first = clock()
    while True:
        bright, jitter = draw(torch, gen, chunk, n_rigs, device)
        pending = []
        for t in range(chunk):
            obs = perturbed(pool, bright[t], jitter[t])
            due = None if rate is None else t_first + len(ticks) / rate
            if due is not None and due > clock():
                time.sleep(due - clock())
            t0 = clock()
            new, out = system.step(states, obs)
            t1 = clock()
            rec = {"dispatch_s": t1 - t0, "at_s": t1 - t_first}
            if due is not None:
                rec["late_s"] = t0 - due
            if closed:
                host = {p: _field(out, p).cpu() for p in PUBLISHED}
                t2 = clock()
                start = t0 if due is None else due
                rec.update(readback_s=t2 - t1, latency_s=t2 - start,
                           counts=np.array([int(host["boxes.valid"].sum()),
                                            int(host["poses.valid"].sum()),
                                            int(host["saturation."
                                                     "orientation_dropped"]
                                                .sum())]))
            else:
                pending.append(tick_counts(torch, out))
            if sampler is not None:
                sampler.offer(types.SimpleNamespace(
                    index=len(ticks), pre=states, post=new, out=out,
                    bright=bright[t], jitter=jitter[t]),
                    rec.get("latency_s"))
            if hold is not None:
                hold.append(out)
            ticks.append(rec)
            states = new
            if closed and stop(clock() - t_first):
                return states, ticks, clock() - t_first
        if not closed:
            counts = torch.stack(pending).cpu().numpy()
            for rec, row in zip(ticks[-chunk:], counts):
                rec["counts"] = row
            if stop(clock() - t_first):
                return states, ticks, clock() - t_first


def _seed32(seed: int, salt: int) -> int:
    return int(np.random.SeedSequence([int(seed), salt]).generate_state(
        1, np.uint32)[0])


def traced_work(torch, outs, config: dict) -> dict:
    """What the traced ticks asked of the kernels: frames, the valid crops
    the orientation net ran and the frame pixels their taps read."""
    eng = config["engine"]
    crops, pixels = 0, 0
    for out in outs:
        order, _ = reference.dynamic_slots(out.boxes,
                                           eng["max_orientation_batch"])
        r, j = out.poses.valid.nonzero(as_tuple=True)
        xyxy = out.boxes.xyxy[r, order[r, j]].float().cpu().numpy()
        crops += int(r.shape[0])
        pixels += counts.tapped_pixels(
            xyxy, r.cpu().numpy(), eng["camera_image_height"],
            eng["camera_image_width"], eng["network_height"])
    frames = sum(out.boxes.valid.shape[0] for out in outs)
    return dict(ticks=len(outs), frames=frames, crops=crops,
                tapped_pixels=pixels)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: str | None = None,
             overrides: dict | None = None, log=print) -> dict:
    """One run of a cell; returns the result line's object (with the
    compared numbers under "checks"). control: a Control mode ("tf32",
    "fp8", or one of the detector module's) in the program's place.
    overrides: {"engine": {...}, "traffic": {...}} for tests at small
    sizes."""
    import torch
    manifest, cell, config, traffic, limits = load_cell(workload)
    if overrides:
        config = dict(config, engine=dict(config["engine"],
                                          **overrides.get("engine", {})))
        traffic = dict(traffic, **overrides.get("traffic", {}))
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        # one intra-op thread: idle pool threads spinning beside the
        # dispatching one took host time from it (PERF.md section 2)
        torch.set_num_threads(1)
    n_rigs = traffic["rigs"]
    pool, render_s = build_pool(torch, config, traffic, seed, device)
    log(f"[bench] {workload}: {n_rigs} rigs rendered in {render_s:.3f} s")
    system = (Program(torch, config, n_rigs, device) if control is None
              else Control(torch, config, n_rigs, device, control))
    states = system.init_states(n_rigs)
    init_cells = int(((states.log_odds != config["engine"]["log_odds_prior"])
                      | (states.occupancy
                         != config["engine"]["init_probability"])).sum())
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed32(seed, 1))
    warm = torch.Generator(device=device)
    warm.manual_seed(_seed32(seed, 2))
    drive(torch, system, pool, system.init_states(n_rigs), traffic, warm,
          device, sync, lambda s: True)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    sampler = Sampler(traffic["check_ticks"],
                      np.random.default_rng([int(seed), 3]),
                      traffic["loop"] == "tick")
    states, ticks, window_s = drive(torch, system, pool, states, traffic, gen,
                                    device, sync, lambda s: s >= seconds,
                                    sampler)
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    summary = work = None
    if trace:
        held = []
        tgen = torch.Generator(device=device)
        tgen.manual_seed(_seed32(seed, 4))
        n_traced = traffic["trace_ticks"]
        summary = trace_mod.profile(
            lambda: drive(torch, system, pool, states, traffic, tgen, device,
                          sync, lambda s: len(held) >= n_traced, hold=held),
            sync)
        work = traced_work(torch, held, config)
        del held
    log(f"[bench] window {window_s:.3f} s, {len(ticks)} ticks, set-up "
        f"{setup_s:.3f} s, peak {memory_peak} B")
    samples = sampler.samples()
    del system, states
    if on_card:
        torch.cuda.empty_cache()
    checks, seen, failed = judge_samples(torch, config, traffic, pool,
                                         samples, limits, device, init_cells)
    correct = failed == 0
    rec = types.SimpleNamespace(
        workload=workload, config=config, traffic=traffic, ticks=ticks,
        window_s=window_s, frames=len(ticks) * n_rigs, setup_s=setup_s,
        memory_peak_bytes=memory_peak, trace=summary, work=work,
        peak_ops=counts.PEAKS[config["peak"]])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, workload, kind):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(ticks) * n_rigs,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": memory_peak}}
    if trace:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = trace_mod.breakdown(summary)
    # the window's rate second by second, to tell a run's own swings from
    # those between runs
    at = np.array([t["at_s"] for t in ticks])
    late = [t["late_s"] for t in ticks if "late_s" in t]
    if late:
        # how late the open loop's generator sent its ticks
        seen["late_ms_max"] = max(late) * 1e3
        seen["late_ms_median"] = float(np.median(late)) * 1e3
    seen["frames_per_s_by_second"] = [
        float(((at >= i) & (at < i + 1)).sum() * n_rigs)
        for i in range(int(window_s))]
    result["readings"] = seen
    result["checks"] = checks
    return result


def judge_samples(torch, config, traffic, pool, samples, limits, device,
                  init_cells: int):
    """({number: {"value": worst, "limit": limit}}, {reading: value} of
    what is looked at but not compared, rig-ticks failed)."""
    reference.ieee()
    nets = weights(config, device)
    detect = detector(config).detect_dense
    eye = torch.eye(4, device=device)
    budget = config["orientation_budget_per_rig"] * traffic["rigs"]
    worst = {k: 0.0 for k in judge_mod.NUMBERS}
    worst["det_px"] = 0.0
    gaps, failed = [], 0
    for s in samples:
        sample = types.SimpleNamespace(obs=perturbed(pool, s.bright,
                                                     s.jitter),
                                       pre=s.pre, post=s.post, out=s.out)
        rigs, g = judge_mod.judge(nets, sample, config["engine"], budget,
                                  eye, eye, detect)
        gaps.append(g)
        bad = torch.zeros(traffic["rigs"], dtype=torch.bool)
        for k, v in rigs.items():
            worst[k] = max(worst[k], float(v.max()))
            if k in limits:
                bad |= v > limits[k]
        failed += int(bad.sum())
    gaps = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)

    def far_pct(gap: float) -> float:
        return (100.0 * float((gaps > gap).double().mean()) if gaps.numel()
                else 0.0)

    if gaps.numel():
        worst["pose_gap"] = float(gaps.median())
    worst["pose_far"] = far_pct(limits.get("pose_far_gap", float("inf")))
    checks = {k: {"value": worst[k], "limit": limits[k]}
              for k in judge_mod.NUMBERS if k in limits}
    checks["init_cells"] = {"value": float(init_cells), "limit": 0.0}
    # a lower limit: the ticks judged, at least the mix's check_ticks
    checks["ticks_judged"] = {"value": float(len(samples)),
                              "min": float(traffic["check_ticks"])}
    judged_rigs = len(samples) * traffic["rigs"]
    if any(worst[k] > limits[k] for k in judge_mod.POOLED if k in limits) \
            or init_cells or len(samples) < traffic["check_ticks"]:
        failed = max(failed, judged_rigs, 1)
    seen = {k: worst[k] for k in worst if k not in checks}
    seen["pose_far_pct_at"] = {f"{g:g}": far_pct(g)
                               for g in judge_mod.FAR_LADDER}
    seen.update({"poses_judged": float(gaps.numel()),
            "pose_gap_p90": (float(torch.quantile(gaps, 0.9))
                             if gaps.numel() else 0.0),
            "pose_gap_max": float(gaps.max()) if gaps.numel() else 0.0})
    return checks, seen, failed
