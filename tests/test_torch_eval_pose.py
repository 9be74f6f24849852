"""The pose harness (train/eval_pose.py) against the JAX package's on the
same scenes (4 frames, seed 3000, oracle boxes, the shipped orientation
weights): equal ground-truth, pose and match counts; the position-error
statistics (unrounded: the module's round is lifted in both packages) to
1e-4, with the depth refine to 1e-3 (it amplifies the solver's 1e-4,
tests/test_torch_extension_tick.py)."""

import pytest
import torch

import grid_vision_tpu.train.eval_pose as jeval_pose
import grid_vision_tpu_torch.train.eval_pose as eval_pose

torch.set_num_threads(1)

STATS = ("pos_err_median_m", "pos_err_mean_m", "pos_err_p90_m",
         "within_1m_frac")


@pytest.mark.parametrize("mode,refine,tol", [("pca", False, 1e-4),
                                             ("vision", False, 1e-4),
                                             ("vision", True, 1e-3)])
def test_evaluate_poses_matches_jax(mode, refine, tol, monkeypatch):
    for mod in (jeval_pose, eval_pose):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x,
                            raising=False)
    want = jeval_pose.evaluate_poses(mode, n_frames=4, refine=refine)
    got = eval_pose.evaluate_poses(mode, n_frames=4, refine=refine,
                                   device="cpu")
    for key in ("mode", "det", "refine", "frames", "n_gt", "n_pred",
                "n_matched"):
        assert got[key] == want[key], (key, got, want)
    assert want["n_matched"] > 0
    for key in STATS:
        assert abs(got[key] - want[key]) <= tol, (key, got, want)
