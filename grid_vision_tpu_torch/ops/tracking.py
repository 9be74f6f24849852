"""Multi-object tracking on tensors: persistent object identity and
velocity (counterpart of grid_vision_tpu/ops/tracking.py).

The reference has no temporal object state: every tick it republishes
anonymous markers (publishObjectVisualizations, grid_vision_node.cpp:
405-523). The tracker is a pure-additive extension: it consumes a finished
StepOutput and keeps its own state, and nothing of the reference outputs
changes.

  - TrackState is a fixed-capacity masked slot table; `id` is the stable
    identity (monotonic, never reused).
  - Association is greedy best-IoU matching of the velocity-predicted
    track boxes with the frame's detections, the IoU attenuated by the 3D
    distance where both sides carry a pose; lost tracks return through a
    3D motion gate (re-acquisition); unmatched detections spawn into free
    slots, lowest slot first, in confidence order.
  - 3D state (base-frame position and velocity) is an alpha-beta filter
    of the step's own pose estimates: dynamic boxes from the poses, static
    boxes from the kNN-depth static_points.

Every function takes an optional leading rig axis on its tensors (a fleet's
StepOutput, TrackState.create(..., rigs=R)): the single rig runs the
rig-batched code at R = 1. Nothing here reads a device value back to the
host: the greedy matcher runs a fixed min(T, D) passes (the JAX package's
while_loop exits once no positive score is left; the passes after that
change nothing), and every count stays a tensor.

Rounding follows the JAX package's jitted XLA program on the CPU, which
contracts ``a + b * c`` into one fused multiply-add: those sites go through
`_fma` (exact product in f64, rounded once to f32). A CUDA tensor divided by
a Python scalar is multiplied by its reciprocal, an ulp off a division, so
divisions by configuration constants divide by a device tensor.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import GridVisionConfig
from ..taxonomy import is_dynamic
from ..types import _map, _take_rows, _Tensors, StepOutput
from .rasterize import yaw_from_quat


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static tracker configuration (the JAX package's TrackConfig: the
    same fields and defaults; see its docstring for each one's meaning)."""

    capacity: int = 32
    iou_min: float = 0.3
    class_gated: bool = True
    max_misses: int = 5
    min_hits: int = 2
    spawn_confidence: float = 0.0
    pos_gain: float = 0.5
    vel_gain: float = 0.1
    box_vel_alpha: float = 0.5
    purgatory: int = 40
    reacq_radius: float = 1.5
    reacq_radius_rate: float = 2.0
    occl_coast_iou: float = 0.0
    match_depth_scale: float = 2.0


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to f32 (XLA's contracted form): the
    product of two f32 values is exact in f64."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    else:                      # a Python constant enters XLA as an f32
        b = float(torch.tensor(b, dtype=torch.float32))
    return (a.double() * b + c.double()).float()


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on like's device (a fill, not a host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm over a last axis of 3 as XLA's CPU program sums it:
    sqrt(fma(x2, x2, fma(x1, x1, x0 * x0)))."""
    x = x.double()
    acc = (x[..., 0] * x[..., 0]).float().double()
    acc = (acc + x[..., 1] * x[..., 1]).float().double()
    return torch.sqrt((acc + x[..., 2] * x[..., 2]).float())


@dataclasses.dataclass(frozen=True)
class TrackState(_Tensors):
    """Padded track table, slot-indexed (T slots; fields may carry a
    leading rig axis).

    xyxy / vel_px (T, 4): last matched or coasted pixel box and its
    d(xyxy)/dt EMA; position / velocity (T, 3): base-frame 3D state;
    quat (T, 4), length / width / height (T,): last matched 3D box;
    label (T,) int32, confidence (T,); id (T,) int32 stable identity;
    hits / misses / age (T,) int32; valid / has_pose (T,) bool;
    next_id () int32."""

    xyxy: torch.Tensor
    vel_px: torch.Tensor
    position: torch.Tensor
    velocity: torch.Tensor
    quat: torch.Tensor
    length: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    label: torch.Tensor
    confidence: torch.Tensor
    id: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    age: torch.Tensor
    valid: torch.Tensor
    has_pose: torch.Tensor
    next_id: torch.Tensor

    @staticmethod
    def create(tcfg: TrackConfig, device=None,
               rigs: int | None = None) -> "TrackState":
        """An empty table; rigs=R stacks R of them on a leading axis."""
        lead = () if rigs is None else (rigs,)
        t = tcfg.capacity
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        quat = torch.zeros(lead + (t, 4), **f32)
        quat[..., 3] = 1.0
        return TrackState(
            xyxy=torch.zeros(lead + (t, 4), **f32),
            vel_px=torch.zeros(lead + (t, 4), **f32),
            position=torch.zeros(lead + (t, 3), **f32),
            velocity=torch.zeros(lead + (t, 3), **f32), quat=quat,
            length=torch.zeros(lead + (t,), **f32),
            width=torch.zeros(lead + (t,), **f32),
            height=torch.zeros(lead + (t,), **f32),
            label=torch.full(lead + (t,), 10, **i32),
            confidence=torch.zeros(lead + (t,), **f32),
            id=torch.full(lead + (t,), -1, **i32),
            hits=torch.zeros(lead + (t,), **i32),
            misses=torch.zeros(lead + (t,), **i32),
            age=torch.zeros(lead + (t,), **i32),
            valid=torch.zeros(lead + (t,), dtype=torch.bool, device=device),
            has_pose=torch.zeros(lead + (t,), dtype=torch.bool,
                                 device=device),
            next_id=torch.zeros(lead, **i32))

    @property
    def capacity(self) -> int:
        return self.xyxy.shape[-2]

    def confirmed(self, tcfg: TrackConfig) -> torch.Tensor:
        """(..., T) bool: live tracks with enough history to trust, not
        lost (misses > max_misses) — unless occl_coast_iou > 0 and the
        lost track's coasted box overlaps a nearer reported track's above
        it (occlusion evidence)."""
        live = self.valid & (self.hits >= tcfg.min_hits)
        reported = live & (self.misses <= tcfg.max_misses)
        if tcfg.purgatory > 0 and tcfg.occl_coast_iou > 0.0:
            lost = live & (self.misses > tcfg.max_misses) & self.has_pose
            iou = cross_iou(self.xyxy, self.xyxy)
            dist = _norm3(self.position)
            occluder = (reported[..., None, :] & self.has_pose[..., None, :]
                        & (dist[..., None, :] < dist[..., :, None])
                        & (iou > tcfg.occl_coast_iou))
            reported = reported | (lost & occluder.any(dim=-1))
        return reported


@dataclasses.dataclass(frozen=True)
class TrackStats(_Tensors):
    """Per-step tracker telemetry, int32 each (per rig with a rig axis)."""

    matched: torch.Tensor
    spawned: torch.Tensor
    killed: torch.Tensor
    spawn_dropped: torch.Tensor   # unmatched detections lost to a full table
    reacquired: torch.Tensor      # lost tracks resumed by the 3D gate


_FIELDS = [f.name for f in dataclasses.fields(TrackState)]


def track_state_from_numpy(d, device=None) -> TrackState:
    """A TrackState from a mapping of numpy arrays by field name (the JAX
    package's TrackState read back field by field): the carry-across."""
    return TrackState(**{k: torch.as_tensor(np.array(d[k])).to(device)
                         for k in _FIELDS})


def cross_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., T, 4) x (..., D, 4) -> (..., T, D) IoU (ops.nms.pairwise_iou's
    denominator convention). The union rounds as the JAX package's jitted
    update_tracks computes it, fma(w_b, h_b, area_a) - inter (whether XLA
    contracts it depends on the loop it fuses into: a standalone jitted
    cross_iou may round it plainly, a few ulps apart)."""
    a = a_xyxy[..., :, None, :]
    b = b_xyxy[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(x2 - x1, min=0.0)
    ih = torch.clamp(y2 - y1, min=0.0)
    inter = iw * ih
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    bw, bh = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    denom = _fma(bw, bh, aw * ah) - inter
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where(denom > 0, inter / safe, torch.zeros_like(denom))


def greedy_match(score: torch.Tensor):
    """Greedy one-to-one assignment on a (..., T, D) score matrix: take the
    global maximum among the still-unmatched pairs while it is > 0 (the
    first maximum in row-major order on ties), then retire its row and
    column. Ineligible pairs must be pre-masked to <= 0. Returns
    (tmatch (..., T), dmatch (..., D)), int64 det / track index or -1.

    Runs min(T, D) passes of six launches each (a batched max, the taken
    pair's scatter, its row and column, two scatters that retire them),
    with no host sync. Once the maximum is <= 0 no pair is taken
    any more (the JAX package's while_loop stops there); the retiring of a
    row and column that such a pass still does changes no positive
    score."""
    lead = score.shape[:-2]
    t, d = score.shape[-2:]
    s = score.reshape(-1, t * d).clone()
    n = s.shape[0]
    s3 = s.view(n, t, d)
    # the taken pairs keep their (positive) score; a pass whose maximum is
    # <= 0 may point at a retired, taken pair: amax leaves that one as is
    taken = torch.zeros_like(s)
    for _ in range(min(t, d)):
        best, flat = s.max(dim=1, keepdim=True)
        taken.scatter_reduce_(1, flat, best, reduce="amax")
        i = torch.div(flat, d, rounding_mode="floor")
        s3.scatter_(1, i[:, :, None].expand(n, 1, d), -1.0)
        s3.scatter_(2, torch.remainder(flat, d)[:, :, None].expand(n, t, 1),
                    -1.0)
    taken = taken.view(n, t, d) > 0.0
    tmatch = torch.where(taken.any(2), taken.to(torch.uint8).argmax(2), -1)
    dmatch = torch.where(taken.any(1), taken.to(torch.uint8).argmax(1), -1)
    return tmatch.view(lead + (t,)), dmatch.view(lead + (d,))


def _scatter_rows(base: torch.Tensor, order: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """base with base[..., order[k], :] = rows[..., k, :] (order distinct
    along its last axis; trailing axes of base ride along)."""
    extra = base.dim() - order.dim()
    idx = order.reshape(order.shape + (1,) * extra).expand(
        order.shape + base.shape[order.dim():])
    return base.scatter(order.dim() - 1, idx, rows)


def per_box_pose(out: StepOutput, cfg: GridVisionConfig):
    """Align the step's 3D estimates to detection-box slots.

    Returns (position (..., D, 3), quat (..., D, 4), dims (..., D, 3) lwh,
    has_pose (..., D)), base frame, one row per box slot:
      - static boxes take static_points, where static_depths carries a
        real measurement (a -1.0 sentinel back-projects behind the camera);
      - dynamic boxes take out.poses: with use_vision_orientation the poses
        are the compacted dynamic batch, scattered back in the order
        pipeline._compact_dynamic takes (dynamic slots first, stable), so
        fleet poses beyond the orientation budget stay invalid; in the PCA
        branch they are box-aligned already."""
    boxes, poses = out.boxes, out.poses
    lead = boxes.valid.shape
    zeros3 = torch.zeros(lead + (3,), dtype=torch.float32,
                         device=boxes.valid.device)
    ident = torch.zeros(lead + (4,), dtype=torch.float32,
                        device=boxes.valid.device)
    ident[..., 3] = 1.0
    dims = torch.stack([poses.length, poses.width, poses.height], dim=-1)
    if not cfg.use_vision_orientation:
        pos, quat, hasp = poses.position, poses.quat, poses.valid
    else:
        dyn = boxes.valid & is_dynamic(boxes.label)
        order = torch.sort((~dyn).to(torch.uint8), dim=-1,
                           stable=True).indices[..., :poses.capacity]
        pos = _scatter_rows(zeros3, order, poses.position)
        quat = _scatter_rows(ident, order, poses.quat)
        dims = _scatter_rows(zeros3, order, dims)
        hasp = torch.zeros_like(dyn).scatter(-1, order, poses.valid)
    static = out.static_boxes.valid
    static_measured = static & (out.static_depths > 0.0)
    s = static[..., None]
    pos = torch.where(s, out.static_points, pos)
    quat = torch.where(s, ident, quat)
    dims = torch.where(s, zeros3, dims)
    hasp = torch.where(static, static_measured, hasp)
    return pos, quat, dims, hasp


def _dt_tensor(dt, like: torch.Tensor) -> torch.Tensor:
    """dt as a 0-d f32 tensor on like's device (never read back)."""
    if isinstance(dt, torch.Tensor):
        return dt.to(device=like.device, dtype=torch.float32)
    return _const(float(dt), like)


def _pick(m: torch.Tensor, on: torch.Tensor, off: torch.Tensor):
    """where(m, on, off) with m (..., T) broadcast over trailing axes."""
    return torch.where(m.reshape(m.shape + (1,) * (on.dim() - m.dim())),
                       on, off)


def update_tracks(tracks: TrackState, out: StepOutput, dt,
                  cfg: GridVisionConfig, tcfg: TrackConfig,
                  match_fn=None):
    """One tracker tick: predict -> match -> update / coast / kill -> 3D
    re-acquisition -> spawn. Returns (TrackState, TrackStats).

    tracks and out carry the same leading axes: none (one rig) or (R,)
    (a fleet's StepOutput and TrackState.create(..., rigs=R)). dt is a
    Python float or a 0-d tensor. match_fn has greedy_match's contract on
    (R, T, D) scores (train/eval_tracking.hungarian_match is the optimal
    drop-in of the MOT A/B)."""
    if tracks.next_id.dim() == 0:
        new, stats = update_tracks(_map(tracks, lambda x: x[None]),
                                   _map(out, lambda x: x[None]), dt, cfg,
                                   tcfg, match_fn)
        return new.select(0), stats.select(0)
    match_fn = match_fn or greedy_match
    dt = _dt_tensor(dt, tracks.xyxy)
    inv_dt = torch.ones_like(dt) / torch.clamp(dt, min=1e-6)
    boxes = out.boxes
    d_cap = boxes.capacity
    det_pos, det_quat, det_dims, det_hasp = per_box_pose(out, cfg)

    # --- predict + match ---------------------------------------------------
    pred_xyxy = _fma(tracks.vel_px, dt, tracks.xyxy)
    iou = cross_iou(pred_xyxy, boxes.xyxy)                   # (R, T, D)
    # lost tracks (re-acquisition purgatory) sit out the IoU stage
    lost_pre = tracks.misses > tcfg.max_misses
    gate = ((tracks.valid & ~lost_pre)[..., :, None]
            & boxes.valid[..., None, :])
    if tcfg.class_gated:
        gate = gate & (tracks.label[..., :, None] == boxes.label[..., None, :])
    gate = gate & (iou >= tcfg.iou_min)
    pred_pos3 = _fma(tracks.velocity, dt, tracks.position)
    score = iou
    if tcfg.match_depth_scale > 0.0:
        # 3D disambiguation of a pixel-space crossing: only reorders the
        # gated pairs where both sides carry a pose
        d3 = _norm3(pred_pos3[..., :, None, :] - det_pos[..., None, :, :])
        both = tracks.has_pose[..., :, None] & det_hasp[..., None, :]
        score = torch.where(
            both, iou * torch.exp(-d3 / _const(tcfg.match_depth_scale, d3)),
            iou)
    # iou_min may be 0: bias the gated scores positive
    tmatch, dmatch = match_fn(torch.where(gate, score + 1e-6,
                                          _const(-1.0, score)))
    matched = tmatch >= 0
    j = torch.clamp(tmatch, 0, d_cap - 1)            # det index per slot

    # --- matched tracks: measurement update --------------------------------
    new_box = _take_rows(boxes.xyxy, j)
    vel_obs = (new_box - tracks.xyxy) * inv_dt
    # first re-observation (hits == 1): the raw delta, no EMA warm-up
    a_box = torch.where(tracks.hits <= 1, _const(1.0, dt),
                        _const(tcfg.box_vel_alpha, dt))[..., None]
    vel_px_m = _fma(1.0 - a_box, tracks.vel_px, a_box * vel_obs)
    det_pos_j = _take_rows(det_pos, j)
    d_hasp = torch.take_along_dim(det_hasp, j, dim=-1)
    can_v3 = tracks.has_pose & d_hasp
    # alpha-beta filter: predict, blend the innovation into position
    # (pos_gain) and velocity (vel_gain / dt); a track whose velocity is
    # still zero takes the raw frame delta once
    innov = det_pos_j - pred_pos3
    first_v3 = can_v3 & (tracks.velocity.abs().sum(-1) == 0.0)
    v3_raw = (det_pos_j - tracks.position) * inv_dt
    vel_ab = _fma(inv_dt * tcfg.vel_gain, innov, tracks.velocity)
    vel3_m = _pick(can_v3, _pick(first_v3, v3_raw, vel_ab),
                   tracks.velocity)
    pos_ab = _fma(innov, tcfg.pos_gain, pred_pos3)
    pos_m = _pick(d_hasp, _pick(can_v3 & ~first_v3, pos_ab, det_pos_j),
                  pred_pos3)

    # --- unmatched tracks: coast, then kill --------------------------------
    coast = tracks.valid & ~matched
    killed = coast & (tracks.misses + 1 > tcfg.max_misses + tcfg.purgatory)
    alive = tracks.valid & ~killed
    m_pose = matched & d_hasp
    det_dims_j = _take_rows(det_dims, j)
    upd = TrackState(
        xyxy=_pick(matched, new_box, pred_xyxy),
        vel_px=_pick(matched, vel_px_m, tracks.vel_px),
        position=_pick(matched, pos_m, pred_pos3),
        velocity=_pick(matched, vel3_m, tracks.velocity),
        quat=_pick(m_pose, _take_rows(det_quat, j), tracks.quat),
        length=_pick(m_pose, det_dims_j[..., 0], tracks.length),
        width=_pick(m_pose, det_dims_j[..., 1], tracks.width),
        height=_pick(m_pose, det_dims_j[..., 2], tracks.height),
        label=tracks.label,
        confidence=_pick(matched,
                         torch.take_along_dim(boxes.confidence, j, dim=-1),
                         tracks.confidence),
        id=tracks.id,
        hits=tracks.hits + matched.to(torch.int32),
        misses=torch.where(matched, 0,
                           tracks.misses + coast.to(torch.int32)),
        age=tracks.age + tracks.valid.to(torch.int32),
        valid=alive,
        has_pose=tracks.has_pose | (matched & d_hasp),
        next_id=tracks.next_id)

    # --- re-acquire lost tracks through the 3D motion gate -----------------
    dmatch2 = torch.full_like(dmatch, -1)
    rematched = torch.zeros_like(matched)
    if tcfg.purgatory > 0:
        lost_now = upd.valid & (upd.misses > tcfg.max_misses) & upd.has_pose
        cand = (boxes.valid & (dmatch < 0) & det_hasp
                & (boxes.confidence >= tcfg.spawn_confidence))
        # upd.position carries this frame's coast: the CV prediction
        t_lost = upd.misses.to(torch.float32) * dt
        radius = _fma(t_lost, tcfg.reacq_radius_rate,
                      _const(tcfg.reacq_radius, t_lost).expand_as(t_lost))
        dist = _norm3(upd.position[..., :, None, :]
                      - det_pos[..., None, :, :])
        rgate = lost_now[..., :, None] & cand[..., None, :]
        if tcfg.class_gated:
            rgate = rgate & (upd.label[..., :, None]
                             == boxes.label[..., None, :])
        rgate = rgate & (dist < radius[..., None])
        tmatch2, dmatch2 = match_fn(torch.where(
            rgate, radius[..., None] - dist + 1e-6, _const(-1.0, dist)))
        rematched = tmatch2 >= 0
        j2 = torch.clamp(tmatch2, 0, d_cap - 1)
        # measurement update over the whole lost gap (alpha-beta with
        # dt = t_lost)
        det_pos_j2 = _take_rows(det_pos, j2)
        innov2 = det_pos_j2 - upd.position
        gap = torch.maximum(t_lost, dt)
        pos_r = _fma(innov2, tcfg.pos_gain, upd.position)
        vel_r = _fma((_const(tcfg.vel_gain, gap) / gap)[..., None], innov2,
                     upd.velocity)
        dims2 = _take_rows(det_dims, j2)
        upd = dataclasses.replace(
            upd,
            xyxy=_pick(rematched, _take_rows(boxes.xyxy, j2), upd.xyxy),
            # pixel velocity is stale after the gap: restart from zero
            vel_px=_pick(rematched, torch.zeros_like(upd.vel_px),
                         upd.vel_px),
            position=_pick(rematched, pos_r, upd.position),
            velocity=_pick(rematched, vel_r, upd.velocity),
            quat=_pick(rematched, _take_rows(det_quat, j2), upd.quat),
            length=_pick(rematched, dims2[..., 0], upd.length),
            width=_pick(rematched, dims2[..., 1], upd.width),
            height=_pick(rematched, dims2[..., 2], upd.height),
            confidence=_pick(rematched, torch.take_along_dim(
                boxes.confidence, j2, dim=-1), upd.confidence),
            hits=upd.hits + rematched.to(torch.int32),
            misses=torch.where(rematched, 0, upd.misses))

    # --- spawn unmatched detections into free slots ------------------------
    free = ~alive
    free_rank = torch.cumsum(free.to(torch.int32), dim=-1) - 1
    n_free = free.to(torch.int32).sum(-1)
    spawnable = (boxes.valid & (dmatch < 0) & (dmatch2 < 0)
                 & (boxes.confidence >= tcfg.spawn_confidence))
    n_spawnable = spawnable.to(torch.int32).sum(-1)
    sp_key = torch.where(spawnable, -boxes.confidence,
                         _const(math.inf, boxes.confidence))
    det_order = torch.sort(sp_key, dim=-1, stable=True).indices
    src = torch.take_along_dim(
        det_order, torch.clamp(free_rank, 0, d_cap - 1).long(), dim=-1)
    do = free & (free_rank < n_spawnable[..., None])
    n_spawned = torch.minimum(n_spawnable, n_free)
    dims_s = _take_rows(det_dims, src)
    new = TrackState(
        xyxy=_pick(do, _take_rows(boxes.xyxy, src), upd.xyxy),
        vel_px=_pick(do, torch.zeros_like(upd.vel_px), upd.vel_px),
        position=_pick(do, _take_rows(det_pos, src), upd.position),
        velocity=_pick(do, torch.zeros_like(upd.velocity), upd.velocity),
        quat=_pick(do, _take_rows(det_quat, src), upd.quat),
        length=_pick(do, dims_s[..., 0], upd.length),
        width=_pick(do, dims_s[..., 1], upd.width),
        height=_pick(do, dims_s[..., 2], upd.height),
        label=_pick(do, torch.take_along_dim(boxes.label, src, dim=-1),
                    upd.label),
        confidence=_pick(do, torch.take_along_dim(boxes.confidence, src,
                                                  dim=-1), upd.confidence),
        id=_pick(do, tracks.next_id[..., None] + free_rank, upd.id),
        hits=torch.where(do, 1, upd.hits),
        misses=torch.where(do, 0, upd.misses),
        age=torch.where(do, 0, upd.age),
        valid=upd.valid | do,
        has_pose=_pick(do, torch.take_along_dim(det_hasp, src, dim=-1),
                       upd.has_pose),
        next_id=tracks.next_id + n_spawned)
    i32 = torch.int32
    stats = TrackStats(
        matched=matched.to(i32).sum(-1, dtype=i32),
        spawned=n_spawned,
        killed=killed.to(i32).sum(-1, dtype=i32),
        spawn_dropped=torch.clamp(n_spawnable - n_free, min=0),
        reacquired=rematched.to(i32).sum(-1, dtype=i32))
    return new, stats


def _cell_axes(cfg: GridVisionConfig, device):
    """The base-frame x of every grid row (H,) and y of every column (W,):
    geometry.grid_position_from_index's cell centres, which are separable,
    from fills and aranges only (no host-to-device copy)."""
    h, w = cfg.grid_size
    lengths = (float(cfg.grid_x), float(cfg.grid_y))
    f32 = dict(dtype=torch.float32, device=device)
    axes = []
    for n, c, length in zip((h, w), cfg.grid_center, lengths):
        max_corner = (torch.full((), c, **f32)
                      + 0.5 * torch.full((), length, **f32))
        idx = torch.arange(n, **f32)
        axes.append(_fma(-(idx + 0.5), cfg.resolution,
                         max_corner.expand(n)))
    return axes


def forecast_occupancy(tracks: TrackState, horizons,
                       cfg: GridVisionConfig, tcfg: TrackConfig,
                       spread_base: float = 0.2,
                       spread_rate: float = 0.5,
                       survival_hazard: float = 0.32) -> torch.Tensor:
    """Predictive occupancy: for each horizon h (seconds), every confirmed
    track with live 3D state projects its yaw-aligned length x width
    footprint at position + velocity * h, softened by
    sigma(h) = spread_base + spread_rate * h meters and discounted by the
    survival exp(-survival_hazard * h); per-cell probabilities combine as
    an independent union over tracks (see the JAX package's docstring for
    the calibration). Returns (..., K, H, W) f32 in [0, 1] on the grid's
    raster. The horizons run one after another, so the temporaries are
    (..., T, H, W) of one horizon at a time."""
    cx, cy = _cell_axes(cfg, tracks.xyxy.device)            # (H,), (W,)
    active = (tracks.confirmed(tcfg) & tracks.has_pose).to(torch.float32)
    yaw = yaw_from_quat(tracks.quat)
    c, s = torch.cos(yaw), torch.sin(yaw)
    hl = torch.clamp(tracks.length / 2.0, min=0.1)
    hw = torch.clamp(tracks.width / 2.0, min=0.1)

    def cells(x):
        return x[..., None, None]

    outs = []
    for h in horizons:
        h = float(h)
        pred = _fma(tracks.velocity[..., :2], h, tracks.position[..., :2])
        sigma = _const(spread_base + spread_rate * h, pred)
        survive = math.exp(-survival_hazard * h)
        rx = cx[:, None] - cells(pred[..., 0])             # (..., T, H, 1)
        ry = cy[None, :] - cells(pred[..., 1])             # (..., T, 1, W)
        # the rotation's products are (..., T, H, 1) and (..., T, 1, W);
        # the sums broadcast to (..., T, H, W)
        u = cells(c) * rx + cells(s) * ry
        v = -cells(s) * rx + cells(c) * ry
        # soft rectangle: ~1 inside, a smooth roll-off over sigma meters
        pu = torch.sigmoid((cells(hl) - u.abs()) / sigma * 4.0)
        pv = torch.sigmoid((cells(hw) - v.abs()) / sigma * 4.0)
        p = survive * pu * pv * cells(active)
        # independent union over tracks: 1 - prod(1 - p)
        outs.append(1.0 - torch.prod(1.0 - p, dim=-3))
    return torch.stack(outs, dim=-3)
