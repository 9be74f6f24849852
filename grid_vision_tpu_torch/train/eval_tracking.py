"""Sequence-level tracker evaluation: MOT metrics over scripted replays
(counterpart of grid_vision_tpu/train/eval_tracking.py).

Scripted >= 200-frame multi-object replays with crossings, mutual
occlusions and spawn / kill churn run through the production
`ops/tracking.update_tracks` and are scored with CLEAR-MOT style aggregates
(IDSW, FRAG, MOTA = 1 - (FN + FP + IDSW) / GT, IDF1 with the optimal
GT <-> id assignment); `forecast_calibration` scores
`forecast_occupancy` against the realized future occupancy. The scenario
generator and the metrics run on the host in numpy, copied from the JAX
package (the same seeds give the same frames); the tracker runs on the
device passed in (the card unless the CPU is asked for), one frame at a
time. Evaluation matching (GT box <-> confirmed track box, IoU >= 0.3) is
scipy's Hungarian solver, so the metric is neutral; `hungarian_match` is
the optimal drop-in for the tracker's own greedy matcher (the A/B that
bounds greedy's cost). It reads the scores back to the host: an
evaluation tool, never the production path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GridVisionConfig
from ..device import resolve_device
from ..ops import tracking
from ..types import Boxes, LShapePoses, SaturationStats, StepOutput


# ---------------------------------------------------------------------------
# optimal matcher (A/B reference for the production greedy matcher)
# ---------------------------------------------------------------------------

def hungarian_match(score: torch.Tensor):
    """Optimal one-to-one assignment on a (..., T, D) score matrix
    (maximizes the total score over pairs with score > 0): greedy_match's
    contract, solved per rig by scipy on the host."""
    import scipy.optimize as so

    lead = score.shape[:-2]
    t, d = score.shape[-2:]
    s_all = score.detach().reshape(-1, t, d).cpu().numpy().astype(np.float64)
    tm = np.full((s_all.shape[0], t), -1, np.int64)
    dm = np.full((s_all.shape[0], d), -1, np.int64)
    for r, s in enumerate(s_all):
        ri, ci = so.linear_sum_assignment(-s)
        for i, j in zip(ri, ci):
            if s[i, j] > 0.0:
                tm[r, i] = j
                dm[r, j] = i
    return (torch.from_numpy(tm).to(score.device).view(lead + (t,)),
            torch.from_numpy(dm).to(score.device).view(lead + (d,)))


# ---------------------------------------------------------------------------
# scripted scenarios (host numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimObject:
    """One ground-truth object: base-frame constant-velocity box."""
    p0: np.ndarray          # (3,) base-frame position at t_spawn [m]
    v: np.ndarray           # (3,) velocity [m/s]
    size: Tuple[float, float, float] = (1.8, 1.4, 4.2)  # w, h, l
    label: int = 9
    t_spawn: int = 0
    t_kill: int = 10 ** 9   # frame index after which the object is gone


def make_crossing_scenario(seed: int, n_frames: int = 250,
                           dt: float = 0.05) -> List[SimObject]:
    """Crossings + occlusions + churn: pairs of same-class objects on
    intersecting paths (the ID-switch trap), lateral passers that
    occlude what is behind them, and spawn/kill churn through the
    sequence."""
    rng = np.random.default_rng(seed)
    objs: List[SimObject] = []
    horizon = n_frames * dt

    # 3 crossing pairs: start on opposite sides, swap sides mid-sequence
    # (same class — the ID-switch trap; z-separated so the mutual
    # occlusion is a transient window around the crossing, not the
    # whole sequence)
    for k in range(3):
        z = rng.uniform(12, 30)
        x = rng.uniform(2.5, 5.0)
        speed = 2.0 * x / horizon * rng.uniform(1.6, 2.4)
        dz = rng.uniform(-1.0, 1.0)
        objs.append(SimObject(
            p0=np.array([-x, 1.2, z]), v=np.array([speed, 0.0, dz]),
            label=9, t_spawn=0))
        objs.append(SimObject(
            p0=np.array([x, 1.2, z + rng.uniform(4.0, 8.0)]),
            v=np.array([-speed, 0.0, dz]), label=9, t_spawn=0))

    # a near, fast lateral passer: briefly occludes everything behind it
    objs.append(SimObject(
        p0=np.array([-6.0, 1.2, 8.0]), v=np.array([8.0, 0.0, 0.0]),
        label=9, t_spawn=int(n_frames * 0.2),
        t_kill=int(n_frames * 0.75)))

    # churn: late spawns and early kills
    for k in range(3):
        t0 = int(rng.uniform(0.1, 0.6) * n_frames)
        t1 = min(n_frames, t0 + int(rng.uniform(0.25, 0.5) * n_frames))
        objs.append(SimObject(
            p0=np.array([rng.uniform(-4, 4), 1.2, rng.uniform(15, 35)]),
            v=np.array([rng.uniform(-1, 1), 0.0, rng.uniform(-3, 1)]),
            label=int(rng.choice([9, 2])), t_spawn=t0, t_kill=t1))
    return objs


@dataclasses.dataclass
class SimFrames:
    """Stacked per-frame simulation results (T frames, G GT objects,
    D detection slots)."""
    det_xyxy: np.ndarray      # (T, D, 4)
    det_conf: np.ndarray      # (T, D)
    det_label: np.ndarray     # (T, D)
    det_valid: np.ndarray     # (T, D) bool
    det_pos: np.ndarray       # (T, D, 3) noisy 3D position per detection
    det_gt: np.ndarray        # (T, D) GT index per detection (-1 = FP)
    gt_xyxy: np.ndarray       # (T, G, 4) projected GT boxes
    gt_pos: np.ndarray        # (T, G, 3)
    gt_vel: np.ndarray        # (T, G, 3)
    gt_alive: np.ndarray      # (T, G) bool on-screen & within lifetime
    gt_visible: np.ndarray    # (T, G) bool alive & not mutually occluded
                              # (MOT16-style visibility filter: occluded
                              # frames stay matchable — coasted coverage
                              # counts — but are not FN if missed)
    gt_label: np.ndarray      # (G,)
    sizes: np.ndarray         # (G, 3) w, h, l
    dt: float


# camera (x right, y down, z forward) -> base (x forward, y left, z up):
# the frame the tracker's 3D state and the grid raster live in (the
# same rotation demo.default_extrinsics uses)
_R_CB = np.array([[0.0, 0.0, 1.0],
                  [-1.0, 0.0, 0.0],
                  [0.0, -1.0, 0.0]], np.float32)


def _project_box(p: np.ndarray, size, cfg: GridVisionConfig
                 ) -> Optional[np.ndarray]:
    """Base==camera frame here (identity extrinsics): x right, y down,
    z forward. Returns pixel xyxy or None when off-screen/behind."""
    w3, h3, l3 = size
    x, y, z = p
    if z < 2.0:
        return None
    half_w = 0.5 * max(w3, l3 * 0.6)     # crude yaw-agnostic extent
    u0 = cfg.fx * (x - half_w) / z + cfg.cx
    u1 = cfg.fx * (x + half_w) / z + cfg.cx
    v0 = cfg.fy * (y - h3) / z + cfg.cy
    v1 = cfg.fy * y / z + cfg.cy
    if u1 < 0 or u0 > cfg.camera_image_width or v1 < 0 \
            or v0 > cfg.camera_image_height:
        return None
    return np.array([u0, v0, u1, v1], np.float32)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def simulate(objs: List[SimObject], cfg: GridVisionConfig,
             n_frames: int = 250, dt: float = 0.05, seed: int = 0,
             p_dropout: float = 0.05, p_false_positive: float = 0.08,
             box_jitter_px: float = 1.5, pos_noise_m: float = 0.15,
             occl_iou: float = 0.45, p_occl_enter: float = 0.5,
             p_occl_stay: float = 0.92) -> SimFrames:
    """Run the scripted world and the detection-imperfection model.

    Occlusion is a 2-state Markov process per object while the overlap
    condition holds (real detectors lose a partially-occluded object in
    temporally-correlated episodes, not i.i.d. frames): a visible
    object under heavy overlap becomes hidden w.p. p_occl_enter per
    frame; a hidden one stays hidden w.p. p_occl_stay."""
    rng = np.random.default_rng(seed + 7919)
    g = len(objs)
    d_cap = cfg.max_detections
    T = n_frames
    f = SimFrames(
        det_xyxy=np.zeros((T, d_cap, 4), np.float32),
        det_conf=np.zeros((T, d_cap), np.float32),
        det_label=np.full((T, d_cap), 10, np.int32),
        det_valid=np.zeros((T, d_cap), bool),
        det_pos=np.zeros((T, d_cap, 3), np.float32),
        det_gt=np.full((T, d_cap), -1, np.int32),
        gt_xyxy=np.zeros((T, g, 4), np.float32),
        gt_pos=np.zeros((T, g, 3), np.float32),
        gt_vel=np.zeros((T, g, 3), np.float32),
        gt_alive=np.zeros((T, g), bool),
        gt_visible=np.zeros((T, g), bool),
        gt_label=np.asarray([o.label for o in objs], np.int32),
        sizes=np.asarray([o.size for o in objs], np.float32),
        dt=dt)
    hidden = np.zeros((g,), bool)      # Markov occlusion state

    for t in range(T):
        boxes, idxs = [], []
        for i, o in enumerate(objs):
            if not (o.t_spawn <= t < o.t_kill):
                continue
            p = o.p0 + o.v * ((t - o.t_spawn) * dt)   # camera frame
            bb = _project_box(p, o.size, cfg)
            if bb is None:
                continue
            f.gt_xyxy[t, i] = bb
            # 3D state (tracker + grid) lives in the BASE frame
            f.gt_pos[t, i] = _R_CB @ p
            f.gt_vel[t, i] = _R_CB @ o.v
            f.gt_alive[t, i] = True
            boxes.append(bb)
            idxs.append(i)

        # mutual occlusion: the farther of two heavily-overlapping boxes
        # is subject to the Markov hide process (see docstring)
        overlapped = set()
        for a in range(len(boxes)):
            for b in range(a + 1, len(boxes)):
                if _iou(boxes[a], boxes[b]) > occl_iou:
                    ia, ib = idxs[a], idxs[b]
                    far = ia if f.gt_pos[t, ia, 2] > f.gt_pos[t, ib, 2] \
                        else ib
                    overlapped.add(far)
        occluded = set()
        for i in idxs:
            if i in overlapped:
                p = p_occl_stay if hidden[i] else p_occl_enter
                hidden[i] = rng.uniform() < p
            else:
                hidden[i] = False
            if hidden[i]:
                occluded.add(i)
            f.gt_visible[t, i] = not hidden[i]

        entries = []
        for bb, i in zip(boxes, idxs):
            if i in occluded or rng.uniform() < p_dropout:
                continue
            jit = rng.normal(0, box_jitter_px, 4).astype(np.float32)
            entries.append((bb + jit, float(rng.uniform(0.7, 0.95)),
                            int(f.gt_label[i]),
                            f.gt_pos[t, i] + rng.normal(0, pos_noise_m, 3),
                            i))
        if rng.uniform() < p_false_positive:
            u = rng.uniform(40, cfg.camera_image_width - 120)
            v = rng.uniform(120, cfg.camera_image_height - 120)
            z = rng.uniform(10, 35)
            entries.append((
                np.array([u, v, u + rng.uniform(40, 100),
                          v + rng.uniform(30, 80)], np.float32),
                float(rng.uniform(0.6, 0.8)), 9,
                _R_CB @ np.array([(u - cfg.cx) * z / cfg.fx, 1.2, z],
                                 np.float32),
                -1))

        entries.sort(key=lambda e: -e[1])      # post-NMS confidence order
        for s, (bb, conf, lab, pos, gi) in enumerate(entries[:d_cap]):
            f.det_xyxy[t, s] = bb
            f.det_conf[t, s] = conf
            f.det_label[t, s] = lab
            f.det_valid[t, s] = True
            f.det_pos[t, s] = pos
            f.det_gt[t, s] = gi
    return f


# ---------------------------------------------------------------------------
# tracker replay
# ---------------------------------------------------------------------------

def _frames_to_outputs(f: SimFrames, cfg: GridVisionConfig,
                       device=None) -> StepOutput:
    """Stacked (T leading axis) StepOutputs with PCA-aligned poses at the
    noisy detection positions (the alignment per_box_pose uses for
    use_vision_orientation=False)."""
    n, d_cap = f.det_valid.shape
    g_sizes = np.concatenate([f.sizes, [[1.8, 1.4, 4.2]]])  # FP fallback
    lwh = g_sizes[f.det_gt][..., [2, 0, 1]].astype(np.float32)  # l, w, h

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    boxes = Boxes(xyxy=dev(f.det_xyxy), confidence=dev(f.det_conf),
                  label=dev(f.det_label), valid=dev(f.det_valid))
    quat = np.zeros((n, d_cap, 4), np.float32)
    quat[..., 3] = 1.0
    poses = LShapePoses(
        position=dev(f.det_pos), quat=dev(quat), length=dev(lwh[..., 0]),
        width=dev(lwh[..., 1]), height=dev(lwh[..., 2]),
        label=boxes.label, valid=boxes.valid)
    zeros = torch.zeros((n,), dtype=torch.int32, device=device)
    return StepOutput(
        boxes=boxes, poses=poses,
        static_points=torch.zeros((n, d_cap, 3), dtype=torch.float32,
                                  device=device),
        static_depths=torch.full((n, d_cap), -1.0, device=device),
        static_boxes=dataclasses.replace(
            boxes, valid=torch.zeros_like(boxes.valid)),
        occupancy_i8=torch.zeros((n, 1, 1), dtype=torch.int8,
                                 device=device),
        saturation=SaturationStats(zeros, zeros, zeros, zeros, zeros))


SNAPSHOT_KEYS = ("id", "xyxy", "confirmed", "position", "velocity",
                 "has_pose", "length", "width", "quat")


def run_tracker(f: SimFrames, cfg: GridVisionConfig,
                tcfg: tracking.TrackConfig, matcher: str = "greedy",
                device="cuda") -> Dict[str, np.ndarray]:
    """Replay the frames through update_tracks, one call a frame on
    `device`, and snapshot the confirmed-track table of every frame (the
    JAX package's lax.scan; the same snapshot keys). One readback at the
    end."""
    device = resolve_device(device)
    outs = _frames_to_outputs(f, cfg, device)
    if matcher == "hungarian":
        match_fn = hungarian_match
    elif matcher == "greedy":
        match_fn = tracking.greedy_match
    else:
        raise ValueError(f"unknown matcher {matcher!r}")
    tracks = tracking.TrackState.create(tcfg, device=device)
    snaps = {k: [] for k in SNAPSHOT_KEYS}
    for t in range(f.det_valid.shape[0]):
        tracks, _ = tracking.update_tracks(tracks, outs.select(t), f.dt,
                                           cfg, tcfg, match_fn=match_fn)
        conf = tracks.confirmed(tcfg)
        for k in SNAPSHOT_KEYS:
            snaps[k].append(conf if k == "confirmed" else getattr(tracks, k))
    return {k: torch.stack(v).cpu().numpy() for k, v in snaps.items()}


# ---------------------------------------------------------------------------
# MOT metrics (host numpy)
# ---------------------------------------------------------------------------

def mot_metrics(f: SimFrames, snaps: Dict[str, np.ndarray],
                match_iou: float = 0.3) -> Dict[str, float]:
    """CLEAR-MOT style aggregates; evaluation matching is Hungarian on
    IoU (neutral wrt the tracker's own matcher)."""
    import scipy.optimize as so

    T, G = f.gt_alive.shape
    last_id = np.full((G,), -1, np.int64)       # last matched track id
    was_tracked = np.zeros((G,), bool)
    fn = fp = idsw = frag = matches = 0
    # MOT16-style visibility filtering: occluded GT frames stay
    # MATCHABLE (a coasted track covering one counts, and is not an FP)
    # but a miss there is not the tracker's false negative.
    n_gt = int(f.gt_visible.sum())
    # id-association counts for IDF1
    pair_counts: Dict[Tuple[int, int], int] = {}
    total_trk = 0

    for t in range(T):
        gt_idx = np.flatnonzero(f.gt_alive[t])
        trk_idx = np.flatnonzero(snaps["confirmed"][t])
        total_trk += trk_idx.size
        if gt_idx.size and trk_idx.size:
            iou = np.zeros((gt_idx.size, trk_idx.size))
            for a, gi in enumerate(gt_idx):
                for b, ti in enumerate(trk_idx):
                    iou[a, b] = _iou(f.gt_xyxy[t, gi],
                                     snaps["xyxy"][t, ti])
            ri, ci = so.linear_sum_assignment(-iou)
            matched_gt = set()
            matched_trk = set()
            for a, b in zip(ri, ci):
                if iou[a, b] < match_iou:
                    continue
                gi, ti = int(gt_idx[a]), int(trk_idx[b])
                tid = int(snaps["id"][t, ti])
                matched_gt.add(gi)
                matched_trk.add(ti)
                matches += 1
                if last_id[gi] >= 0 and last_id[gi] != tid:
                    idsw += 1
                if not was_tracked[gi] and last_id[gi] >= 0:
                    frag += 1
                last_id[gi] = tid
                was_tracked[gi] = True
                pair_counts[(gi, tid)] = pair_counts.get((gi, tid), 0) + 1
            fn += sum(1 for gi in gt_idx
                      if gi not in matched_gt and f.gt_visible[t, gi])
            fp += trk_idx.size - len(matched_trk)
            for gi in gt_idx:
                if gi not in matched_gt:
                    was_tracked[gi] = False
        else:
            fn += int(f.gt_visible[t].sum())
            fp += trk_idx.size
            was_tracked[f.gt_alive[t]] = False

    # IDF1: optimal global GT<->track-id assignment over match counts
    idf1 = 0.0
    if pair_counts:
        gids = sorted({k[0] for k in pair_counts})
        tids = sorted({k[1] for k in pair_counts})
        m = np.zeros((len(gids), len(tids)))
        for (gi, tid), c in pair_counts.items():
            m[gids.index(gi), tids.index(tid)] = c
        ri, ci = so.linear_sum_assignment(-m)
        idtp = m[ri, ci].sum()
        # IDF1 denominator uses ALL matchable GT frames (occluded ones
        # included — identity should persist through occlusion).
        idf1 = float(2.0 * idtp / max(int(f.gt_alive.sum()) + total_trk,
                                      1))

    return {
        "n_gt": n_gt,
        "n_gt_alive": int(f.gt_alive.sum()),
        "n_frames": T,
        "matches": matches,
        "fn": fn,
        "fp": fp,
        "id_switches": idsw,
        "fragments": frag,
        "mota": float(1.0 - (fn + fp + idsw) / max(n_gt, 1)),
        "idf1": idf1,
    }


def evaluate(seeds=(0, 1, 2, 3), n_frames: int = 250,
             matcher: str = "greedy",
             cfg: Optional[GridVisionConfig] = None,
             tcfg: Optional[tracking.TrackConfig] = None,
             device="cuda") -> Dict[str, float]:
    """Aggregate MOT metrics over several scripted scenarios."""
    cfg = cfg or GridVisionConfig(use_vision_orientation=False)
    tcfg = tcfg or tracking.TrackConfig()
    rows = []
    for s in seeds:
        objs = make_crossing_scenario(s, n_frames)
        f = simulate(objs, cfg, n_frames, seed=s)
        snaps = run_tracker(f, cfg, tcfg, matcher, device)
        rows.append(mot_metrics(f, snaps))
    agg = {k: float(np.sum([r[k] for r in rows]))
           for k in ("n_gt", "matches", "fn", "fp", "id_switches",
                     "fragments")}
    agg["mota"] = float(1.0 - (agg["fn"] + agg["fp"] + agg["id_switches"])
                        / max(agg["n_gt"], 1))
    agg["idf1"] = float(np.mean([r["idf1"] for r in rows]))
    agg["scenarios"] = len(rows)
    agg["per_scenario"] = rows
    return agg


# ---------------------------------------------------------------------------
# predictive-occupancy calibration (forecast_occupancy vs realized)
# ---------------------------------------------------------------------------

def _tracks_from_snapshot(snaps: Dict[str, np.ndarray], t: int,
                          tcfg: tracking.TrackConfig, device=None
                          ) -> tracking.TrackState:
    """Rebuild a TrackState (the fields forecast_occupancy consumes) from a
    run_tracker frame snapshot; confirmed() reproduces the snapshot's
    mask."""
    cap = snaps["id"].shape[1]
    conf = snaps["confirmed"][t]
    z = np.zeros((cap,), np.float32)
    zi = np.zeros((cap,), np.int32)
    return tracking.track_state_from_numpy(dict(
        xyxy=snaps["xyxy"][t], vel_px=np.zeros((cap, 4), np.float32),
        position=snaps["position"][t], velocity=snaps["velocity"][t],
        quat=snaps["quat"][t], length=snaps["length"][t],
        width=snaps["width"][t], height=z, label=zi, confidence=z,
        id=snaps["id"][t],
        hits=np.where(conf, tcfg.min_hits, 0).astype(np.int32),
        misses=zi, age=zi, valid=conf, has_pose=snaps["has_pose"][t],
        next_id=np.zeros((), np.int32)), device)


def _realized_occupancy(f: SimFrames, cfg: GridVisionConfig, t: int,
                        device=None) -> np.ndarray:
    """(H, W) bool GT footprint cover at frame t, on the same raster and
    footprint model as forecast_occupancy (a horizon-0 forecast of the
    exact GT state with a near-delta spread)."""
    g = f.gt_alive.shape[1]
    alive = f.gt_alive[t]
    quat = np.zeros((g, 4), np.float32)
    quat[:, 3] = 1.0
    z = np.zeros((g,), np.float32)
    zi = np.zeros((g,), np.int32)
    gt_tracks = tracking.track_state_from_numpy(dict(
        xyxy=np.zeros((g, 4), np.float32),
        vel_px=np.zeros((g, 4), np.float32), position=f.gt_pos[t],
        velocity=f.gt_vel[t], quat=quat, length=f.sizes[:, 2],
        width=f.sizes[:, 0], height=z, label=zi, confidence=z, id=zi,
        hits=np.full((g,), 2, np.int32), misses=zi, age=zi, valid=alive,
        has_pose=alive, next_id=np.zeros((), np.int32)), device)
    p = tracking.forecast_occupancy(
        gt_tracks, (0.0,), cfg, tracking.TrackConfig(min_hits=1),
        spread_base=0.02, spread_rate=0.0)
    return p[0].cpu().numpy() > 0.5


def forecast_calibration(f: SimFrames, snaps: Dict[str, np.ndarray],
                         cfg: GridVisionConfig,
                         tcfg: tracking.TrackConfig,
                         horizons=(0.5, 1.0, 2.0), stride: int = 5,
                         warmup: int = 20,
                         device="cuda") -> Dict[str, dict]:
    """Score forecast_occupancy against REALIZED future occupancy.

    For sampled frames t, the tracker's forecast at t for t+h is
    compared with the ground-truth footprint cover at t+h:
      - brier: mean squared error of the per-cell probability,
      - brier_persistence: the no-motion baseline (current realized
        occupancy persists) — `skill` = 1 - brier/brier_persistence
        (positive = the velocity model beats assuming nothing moves),
      - reliability: mean predicted probability vs empirical frequency
        in prediction bins (calibration table),
      - hit_rate / false_rate at p>0.5.
    """
    horizons = tuple(float(h) for h in horizons)
    device = resolve_device(device)

    def fc(tr):
        return tracking.forecast_occupancy(tr, horizons, cfg, tcfg)

    def fc_persist(tr):
        # persistence baseline: the SAME tracker state and spread model
        # with the velocity zeroed — isolates exactly what the velocity
        # term buys (a GT-based baseline would smuggle in the tracker's
        # position error and make the comparison unfair both ways)
        return fc(dataclasses.replace(
            tr, velocity=torch.zeros_like(tr.velocity)))
    T = f.gt_alive.shape[0]
    max_hf = int(round(max(horizons) / f.dt))
    bins = np.linspace(0.0, 1.0, 11)
    out = {h: {"sq": 0.0, "sq_persist": 0.0, "n": 0,
               "bin_p": np.zeros(10), "bin_o": np.zeros(10),
               "bin_n": np.zeros(10),
               "tp": 0, "fp": 0, "fn": 0}
           for h in horizons}
    realized_cache: Dict[int, np.ndarray] = {}

    def realized(t):
        if t not in realized_cache:
            realized_cache[t] = _realized_occupancy(f, cfg, t, device)
        return realized_cache[t]

    for t in range(warmup, T - max_hf, stride):
        tracks_t = _tracks_from_snapshot(snaps, t, tcfg, device)
        pred = fc(tracks_t).cpu().numpy()            # (K, H, W)
        pred_persist = fc_persist(tracks_t).cpu().numpy()
        for k, h in enumerate(horizons):
            hf = int(round(h / f.dt))
            obs = realized(t + hf).astype(np.float32)
            p = pred[k]
            o = out[h]
            o["sq"] += float(((p - obs) ** 2).sum())
            o["sq_persist"] += float(
                ((pred_persist[k] - obs) ** 2).sum())
            o["n"] += obs.size
            bi = np.clip(np.digitize(p, bins) - 1, 0, 9)
            for b in range(10):
                m = bi == b
                o["bin_n"][b] += m.sum()
                o["bin_p"][b] += p[m].sum()
                o["bin_o"][b] += obs[m].sum()
            hard = p > 0.5
            o["tp"] += int((hard & (obs > 0.5)).sum())
            o["fp"] += int((hard & (obs <= 0.5)).sum())
            o["fn"] += int((~hard & (obs > 0.5)).sum())

    report = {}
    for h, o in out.items():
        brier = o["sq"] / max(o["n"], 1)
        brier_p = o["sq_persist"] / max(o["n"], 1)
        nz = o["bin_n"] > 0
        report[h] = {
            "brier": brier,
            "brier_persistence": brier_p,
            "skill_vs_persistence": float(1.0 - brier / brier_p)
            if brier_p > 0 else 0.0,
            "reliability": [
                {"bin": f"{bins[b]:.1f}-{bins[b + 1]:.1f}",
                 "mean_pred": float(o["bin_p"][b] / o["bin_n"][b]),
                 "empirical": float(o["bin_o"][b] / o["bin_n"][b]),
                 "n_cells": int(o["bin_n"][b])}
                for b in range(10) if nz[b]],
            "hit_rate": float(o["tp"] / max(o["tp"] + o["fn"], 1)),
            "precision": float(o["tp"] / max(o["tp"] + o["fp"], 1)),
            "frames_scored": int(o["n"] // (np.prod(cfg.grid_size))),
        }
    return report
