"""Training and evaluation of the torch port (counterpart of
grid_vision_tpu/train/): targets, on-device synthetic data, the two losses,
the AdamW train step, the trainers of the CLI's `train detector` /
`train orientation`, the mAP and pose evaluators of `eval` / `eval-pose`,
and the MOT replays (eval_tracking.py)."""
