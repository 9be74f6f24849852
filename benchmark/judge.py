"""The comparison that decides `correct`: one fleet tick's published
outputs against the plain reference (reference.py), layer by layer.

Each stage of the reference is fed the judged tick's own outputs of the
stage before it, as a served model's tokens are fed back to its reference:
the detector is judged on the frames alone; the static branch, the pose
branch and the counters on the judged boxes; the grid on the judged poses
and the judged tick's pre-tick grid (the program's state, which only the
program holds). The numbers, each a rig's worst (R,) but the two pooled
over the judged poses, pose_gap and pose_far:

  det_conf     |confidence - the reference's confidence of that label| at
               the reference anchor that explains the box best (the least
               max(|d confidence|, |d corner| / 32 px))
  det_missed   the confidence above the threshold of the reference's most
               confident box that no judged box overlaps (IoU > 0.5)
  static_m     |static point - the reference's| (metres), static boxes
  pose_gap     the median over the judged poses (not per rig) of each
               pose's gap: the least over the reference's two bins and 64
               constraint combinations of the largest of the bin's logit
               below the best bin's, the combination's residual above the
               best one's (relative), the yaw angle (rad), the position
               (relative to its range) and the dims (m). A pose of a flat
               crop (a channel's deviation under one grey level in the
               reference's crop) only has to be finite (inf otherwise)
  pose_far     the share (%) of those judged poses whose gap is above the
               cell's pose_far_gap: a fault confined to some rigs' or some
               slots' poses moves it where it cannot move the median
  pose_slots  slots whose validity or label differs from the reference's
               choice of crops (the fleet-wide budget on the judged boxes)
  grid_lo      |log-odds - the reference's update of the pre-tick grid|
  grid_cells   occupancy_i8 cells that differ
  counters     saturation counters that differ

Besides (not compared): det_px, the box's corner distance in whole
pixels to its anchor (truncated coordinates: it reads 1 px on sound bf16
runs and 1-2 px under the control), and the pose gaps' 90th percentile
and largest.
"""

from __future__ import annotations

import types

import torch

from . import reference as ref

NUMBERS = ("det_conf", "det_missed", "static_m", "pose_gap", "pose_far",
           "pose_slots", "grid_lo", "grid_cells", "counters")
# the numbers pooled over the judged poses of all judged ticks
POOLED = ("pose_gap", "pose_far")
# the gaps at which the readings give pose_far's share, for its limits
FAR_LADDER = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3,
              1.0)
_BLOCK = 32
FLAT_STD = 1.0                      # grey levels


def _detector(nets, images, boxes, c, detect):
    """det_conf, det_px, det_missed (R,) and the reference's pre-NMS
    overflow (R,); detect: the configuration's detect_dense."""
    size = c["detection_network_input_size"]
    thr = c["confidence_threshold"]
    conf_gap, px_gap, missed, overflow = [], [], [], []
    for i in range(0, images.shape[0], _BLOCK):
        sl = slice(i, i + _BLOCK)
        bn, cn = detect(nets, images[sl], size)
        px = ref.to_pixels(bn, c)                               # (r, A, 4)
        xyxy, conf = boxes.xyxy[sl].float(), boxes.confidence[sl].float()
        label, valid = boxes.label[sl].long().clamp(0, cn.shape[-1] - 1), \
            boxes.valid[sl]
        c_at = torch.gather(cn.transpose(1, 2), 1,
                            label[..., None].expand(-1, -1, cn.shape[1]))
        d_conf = (conf[..., None] - c_at).abs()                 # (r, D, A)
        d_px = (xyxy[:, :, None, :] - px[:, None, :, :]).abs().amax(-1)
        best = torch.argmin(torch.maximum(d_conf, d_px / 32.0), -1)
        g_conf = torch.gather(d_conf, -1, best[..., None])[..., 0]
        g_px = torch.gather(d_px, -1, best[..., None])[..., 0]
        conf_gap.append(torch.where(valid, g_conf, 0.0).amax(-1))
        px_gap.append(torch.where(valid, g_px, 0.0).amax(-1))
        rboxes, ovf = ref.extract_boxes(bn, cn, c)
        iou = ref.cross_iou(rboxes.xyxy, xyxy)                  # (r, D, D)
        covered = ((iou > 0.5) & valid[:, None, :]).any(-1)
        lost = rboxes.valid & ~covered & (rboxes.confidence >= thr)
        missed.append(torch.where(lost, rboxes.confidence - thr, 0.0)
                      .amax(-1))
        overflow.append(ovf)
    return (torch.cat(conf_gap), torch.cat(px_gap), torch.cat(missed),
            torch.cat(overflow))


def _quat_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The rotation angle between unit quaternions, in float64."""
    q1, q2 = q1.double(), q2.double()
    s = torch.where((q1 * q2).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    d = torch.linalg.vector_norm(q1 - s * q2, dim=-1)
    return 4.0 * torch.asin(torch.clamp(d / 2.0, max=1.0))


def _poses(nets, images, boxes, poses, depths, c, budget, K, T_cb):
    """(each judged pose's gap (n,), pose_slots (R,), the reference's
    dropped count (R,))."""
    cap = c["max_orientation_batch"]
    order, slot_valid = ref.dynamic_slots(boxes, cap)
    kept = ref.budget_keep(boxes, order, slot_valid, budget)
    want_label = torch.take_along_dim(boxes.label, order, -1)
    slots = ((kept != poses.valid) | (kept & (poses.label != want_label))
             ).sum(-1)
    gaps = []
    r_idx, j_idx = kept.nonzero(as_tuple=True)
    for i in range(0, r_idx.shape[0], 256):
        r, j = r_idx[i:i + 256], j_idx[i:i + 256]
        b = order[r, j]
        xyxy = boxes.xyxy[r, b].float()
        x, std = ref.crops(images, xyxy, r, c["network_height"])
        o, cf, dm = ref.orientation(nets, x)
        cand = ref.multibin_candidates(o, cf, dm, xyxy, boxes.label[r, b], c,
                                       K)
        locs = cand.locs
        if c["vision_depth_refine"]:
            locs = ref.refine(cand, depths[r, b],
                              torch.ones((), dtype=torch.bool,
                                         device=xyxy.device), K)
        pos = ref.transform(T_cb, locs).double()                # (n,2,64,3)
        p = poses.position[r, j].double()
        e_pos = (p[:, None, None] - pos).abs().amax(-1) / torch.clamp(
            torch.linalg.vector_norm(pos, dim=-1), min=1.0)
        e_yaw = _quat_angle(poses.quat[r, j][:, None],
                            ref.quat_from_pitch(cand.yaw))       # (n, 2)
        dims = torch.stack([cand.length, cand.width, cand.height], -1)
        got = torch.stack([poses.length[r, j], poses.width[r, j],
                           poses.height[r, j]], -1)
        e_dim = (got.double() - dims.double()).abs().amax(-1)    # (n,)
        err = cand.err.double()
        emin = err.amin(-1, keepdim=True)
        e_res = (err - emin) / torch.clamp(emin, min=1e-12)
        e = torch.maximum(torch.maximum(e_pos, e_res), torch.maximum(
            e_yaw, cand.logit_gap.double())[..., None])
        e = torch.maximum(e, e_dim[:, None, None]).flatten(1).amin(-1)
        # a flat crop (a channel's deviation under one grey level) makes
        # the net's output a function of rounding: held to finiteness
        finite = torch.isfinite(p).all(-1) & torch.isfinite(got).all(-1)
        gaps.append(torch.where(finite, e, float("inf"))[
            (std >= FLAT_STD) | ~finite])
    dropped = (slot_valid.sum(-1) - kept.sum(-1)).to(torch.int32)
    gaps = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)
    return gaps, slots, dropped


@torch.no_grad()
def judge(nets, sample, c: dict, budget: int, T_lc, T_cb,
          detect=ref.detect_dense):
    """One judged tick: ({number: (R,)} of the rig-wise numbers and
    det_px, the judged poses' gaps (n,)). sample: obs (image, xyz,
    count), pre and post (log_odds, occupancy), out (the published
    outputs: boxes, poses, static_points, occupancy_i8, saturation);
    detect: the configuration's detect_dense (core.detector)."""
    obs, out = sample.obs, sample.out
    dev = obs.image.device
    K, K_inv = ref.intrinsics(c, dev)
    images = obs.image.float()
    boxes = types.SimpleNamespace(**{k: getattr(out.boxes, k) for k in (
        "xyxy", "confidence", "label", "valid")})
    boxes.xyxy = boxes.xyxy.float()
    det_conf, det_px, det_missed, overflow = _detector(nets, images, boxes,
                                                       c, detect)
    xyz_cam = ref.transform(T_lc, obs.xyz)
    depths, static_points, static_clamped = ref.static_branch(
        boxes, xyz_cam, obs.count, c, K, K_inv, T_cb)
    static = boxes.valid & ~ref.is_dynamic(boxes.label)
    static_m = torch.where(static, (out.static_points.float()
                                    - static_points).abs().amax(-1), 0.0
                           ).amax(-1)
    gaps, pose_slots, dropped = _poses(nets, images, boxes, out.poses,
                                       depths, c, budget, K, T_cb)
    lo, _, i8 = ref.grid_update(sample.pre.log_odds, sample.pre.occupancy,
                                out.poses, ref.transform(T_cb, xyz_cam),
                                obs.count, c, c["raycast_free_space"])
    grid_lo = (sample.post.log_odds - lo).abs().flatten(1).amax(-1)
    grid_cells = (out.occupancy_i8 != i8).flatten(1).sum(-1)
    n_dyn = (boxes.valid & ref.is_dynamic(boxes.label)).sum(-1)
    sat = out.saturation
    want = (("prenms_overflow", overflow),
            ("orientation_clamped",
             torch.clamp(n_dyn - c["max_orientation_batch"], min=0)),
            ("box_cloud_truncated", torch.zeros_like(n_dyn)),
            ("orientation_dropped", dropped),
            ("static_depth_clamped", static_clamped))
    counters = sum((getattr(sat, k).long() != v.long()).long()
                   for k, v in want)
    rigs = dict(det_conf=det_conf, det_missed=det_missed, static_m=static_m,
                pose_slots=pose_slots, grid_lo=grid_lo, grid_cells=grid_cells,
                counters=counters, det_px=det_px)
    return ({k: v.double().cpu() for k, v in rigs.items()},
            gaps.double().cpu())
