"""The port's MOT replays (grid_vision_tpu_torch/train/eval_tracking.py)
against the JAX package's (grid_vision_tpu/train/eval_tracking.py), on the
CPU.

The scripted scenario and its detection-imperfection model are host numpy
copied from the JAX package: the same seed gives the same frames. The
port's run_tracker (one update_tracks a frame) against JAX's (one
lax.scan) on the seed-0 250-frame replay: every snapshot key equal on
every frame (integers and masks exactly, floats within 1e-5; bit-equal in
this run), so the MOT counts equal JAX's; then the floors of
tests/test_tracking.py on the port's own numbers: MOT (MOTA >= 0.82, IDF1
>= 0.55, IDSW <= 60, FP <= 120, FN <= 60), greedy against Hungarian on
seed 1 (MOTA within 0.03, IDSW within 20), and the forecast calibration on
seed 0 (skill over persistence at 0.5 / 1 / 2 s, precision > 0.35 at 1 s,
the well-populated bins >= 0.5 within 0.1 of their empirical frequency at
0.5 and 1 s).
"""

import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops.tracking import TrackConfig as JaxTrackConfig
from grid_vision_tpu.train import eval_tracking as jet
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.ops.tracking import TrackConfig
from grid_vision_tpu_torch.train import eval_tracking as et

torch.set_num_threads(1)

CFG = dict(use_vision_orientation=False)
INT_KEYS = ("id", "confirmed", "has_pose")


@pytest.fixture(scope="module")
def replay():
    cfg = GridVisionConfig(**CFG)
    f = et.simulate(et.make_crossing_scenario(0, 250), cfg, 250, seed=0)
    return f, et.run_tracker(f, cfg, TrackConfig(), device="cpu")


def test_scenario_frames_equal_the_jax_package():
    jf = jet.simulate(jet.make_crossing_scenario(1, 60), JaxConfig(**CFG),
                      60, seed=1)
    f = et.simulate(et.make_crossing_scenario(1, 60), GridVisionConfig(**CFG),
                    60, seed=1)
    for name in ("det_xyxy", "det_conf", "det_label", "det_valid", "det_pos",
                 "det_gt", "gt_xyxy", "gt_pos", "gt_vel", "gt_alive",
                 "gt_visible", "gt_label", "sizes"):
        np.testing.assert_array_equal(getattr(f, name), getattr(jf, name),
                                      name)


def test_run_tracker_snapshots_equal_the_jax_package(replay):
    f, snaps = replay
    jcfg = JaxConfig(**CFG)
    jf = jet.simulate(jet.make_crossing_scenario(0, 250), jcfg, 250, seed=0)
    ref = jet.run_tracker(jf, jcfg, JaxTrackConfig())
    assert snaps.keys() == ref.keys()
    for k, want in ref.items():
        assert snaps[k].shape == want.shape, k
        if k in INT_KEYS:
            np.testing.assert_array_equal(snaps[k], want, k)
        else:
            np.testing.assert_allclose(snaps[k], want, rtol=0, atol=1e-5,
                                       err_msg=k)
    assert et.mot_metrics(f, snaps) == jet.mot_metrics(jf, ref)


def test_mot_quality_floors(replay):
    f, snaps = replay
    m = et.mot_metrics(f, snaps)
    assert m["n_gt"] > 1000
    assert m["mota"] >= 0.82, m
    assert m["idf1"] >= 0.55, m
    assert m["id_switches"] <= 60, m
    assert m["fp"] <= 120, m
    assert m["fn"] <= 60, m


def test_mot_greedy_matches_hungarian():
    cfg = GridVisionConfig(**CFG)
    f = et.simulate(et.make_crossing_scenario(1, 200), cfg, 200, seed=1)
    mg = et.mot_metrics(f, et.run_tracker(f, cfg, TrackConfig(), "greedy",
                                          device="cpu"))
    mh = et.mot_metrics(f, et.run_tracker(f, cfg, TrackConfig(),
                                          "hungarian", device="cpu"))
    assert mg["mota"] >= mh["mota"] - 0.03, (mg, mh)
    assert mg["id_switches"] <= mh["id_switches"] + 20, (mg, mh)
    assert mh != mg                  # the optimal matcher did run


def test_hungarian_match_matches_jax():
    rng = np.random.default_rng(3)
    score = rng.uniform(-0.5, 1.0, (2, 6, 9)).astype(np.float32)
    score[1, :, 4] = -1.0
    tm, dm = et.hungarian_match(torch.from_numpy(score))
    for r in range(2):
        jtm, jdm = jet.hungarian_match(score[r])
        np.testing.assert_array_equal(tm[r].numpy(), np.asarray(jtm))
        np.testing.assert_array_equal(dm[r].numpy(), np.asarray(jdm))
    assert (tm[1] != 4).all()
    with pytest.raises(ValueError):
        et.run_tracker(et.simulate([], GridVisionConfig(**CFG), 2),
                       GridVisionConfig(**CFG), TrackConfig(), "optimal",
                       device="cpu")


def test_forecast_calibration_beats_persistence():
    cfg = GridVisionConfig(**CFG)
    f = et.simulate(et.make_crossing_scenario(0, 200), cfg, 200, seed=0)
    tc = TrackConfig()
    snaps = et.run_tracker(f, cfg, tc, device="cpu")
    cal = et.forecast_calibration(f, snaps, cfg, tc,
                                  horizons=(0.5, 1.0, 2.0), stride=10,
                                  device="cpu")
    for h, r in cal.items():
        assert r["skill_vs_persistence"] > 0.0, (h, r)
    assert cal[1.0]["precision"] > 0.35, cal[1.0]
    for h in (0.5, 1.0):
        for row in cal[h]["reliability"]:
            lo = float(row["bin"].split("-")[0])
            if lo >= 0.5 and row["n_cells"] >= 2000:
                gap = abs(row["mean_pred"] - row["empirical"])
                assert gap <= 0.1, (h, row)
