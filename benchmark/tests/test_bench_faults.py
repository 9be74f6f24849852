"""`correct` is decided by a comparison that fails: a whole run of a cell
(harness, window, reservoir, judge), skipping only the look for a card,
on the CPU at a small size with the program's plain backends, comes out
correct for the sound program and not correct

  - for each configuration's control: the reference in the precision
    below the configuration's (fp8 for bf16, TF32 for f32, int4 for the
    int8 detector) in the program's place; for the int8 cell also the
    float detector in the int8 detector's place (the quantization left
    out) and the float reference in fp8;
  - for each fault a fleet cell can have, planted under the timed path:
    a tick that returns its grid state unchanged; half of the rigs left
    out (their outputs empty, their grids not updated), and within the
    pose branch alone (their poses never computed, the grid updated from
    them); an answer altered
    where it is produced (one box's confidence), in the f32 cell and in
    the int8 cell. A one-card cell has no exchange between cards to leave
    out.
"""

import dataclasses

import pytest

from benchmark import core, judge

PLAIN = {"detector_stem_backend": "xla", "orientation_stem_backend": "xla",
         "grid_backend": "xla", "knn_backend": "xla"}
SMALL = {"rigs": 4, "check_ticks": 2, "chunk": 2}
SEED = 2 ** 31 + 77


def _run(workload, control=None):
    return core.run_cell(workload, SEED, 5.0, False, device="cpu",
                         control=control,
                         overrides={"engine": PLAIN, "traffic": SMALL},
                         log=lambda m: None)


def _state_unchanged(states, new, out):
    return states, out


def _half_left_out(states, new, out):
    half = states.log_odds.shape[0] // 2

    def keep(old, fresh):
        x = fresh.clone()
        x[half:] = old[half:]
        return x

    def empty(x, fill):
        x = x.clone()
        x[half:] = fill
        return x

    state = dataclasses.replace(new, log_odds=keep(states.log_odds,
                                                   new.log_odds),
                                occupancy=keep(states.occupancy,
                                               new.occupancy))
    out = dataclasses.replace(
        out, boxes=dataclasses.replace(out.boxes, valid=empty(
            out.boxes.valid, False)),
        poses=dataclasses.replace(out.poses, valid=empty(out.poses.valid,
                                                         False)),
        static_points=empty(out.static_points, 0.0),
        occupancy_i8=empty(out.occupancy_i8, 50))
    return state, out


def _half_zeroed(poses):
    """Half of the rigs' poses never computed (left at zero), the slots'
    validity and labels kept."""
    half = poses.position.shape[0] // 2

    def zero(x):
        x = x.clone()
        x[half:] = 0
        return x

    return dataclasses.replace(
        poses, position=zero(poses.position), quat=zero(poses.quat),
        length=zero(poses.length), width=zero(poses.width),
        height=zero(poses.height))


def _answer_altered(states, new, out):
    conf = out.boxes.confidence.clone()
    r, d = out.boxes.valid.nonzero()[0].tolist()
    conf[r, d] = conf[r, d] - 0.25
    return new, dataclasses.replace(out, boxes=dataclasses.replace(
        out.boxes, confidence=conf))


@pytest.mark.parametrize("workload", ["f32-ext.r64.tick",
                                      "bf16-fleet.r128.ahead",
                                      "int8-ext.r128.ahead"])
def test_sound_program_is_correct(workload):
    r = _run(workload)
    assert r["attempted"] >= 2 * SMALL["rigs"]
    if not workload.startswith("bf16"):
        assert r["correct"], r["checks"]
        assert r["failed"] == 0
        return
    # On the CPU the bf16 cell runs the plain path, not the bf16 kernels
    # that the card times, and its poses read as far from the reference
    # as the fp8 control's there (pose_far 10-13 % of a few dozen poses,
    # pose_gap about 0.005): the pose limits hold for the timed path only
    # and are shown on the card. Every other number holds here.
    checks = r["checks"]
    for k, c in checks.items():
        if k not in judge.POOLED:
            assert (c["value"] <= c["limit"] if "limit" in c
                    else c["value"] >= c["min"]), checks


@pytest.mark.parametrize("workload", ["f32-ext.r64.tick",
                                      "bf16-fleet.r128.ahead",
                                      "int8-ext.r128.ahead"])
def test_control_is_not_correct(workload):
    _, _, config, _, _ = core.load_cell(workload)
    r = _run(workload, control=config["control"])
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("control", ["float", "fp8"])
def test_int8_controls_are_not_correct(control):
    """The float detector in the int8 detector's place (the quantization
    left out) is refused by det_conf alone: every later stage is fed the
    judged boxes, and the float control's are its own."""
    r = _run("int8-ext.r128.ahead", control=control)
    assert not r["correct"] and r["failed"] > 0
    c = r["checks"]
    if control == "float":
        assert c["det_conf"]["value"] > c["det_conf"]["limit"], c


@pytest.mark.parametrize("workload", ["f32-ext.r64.tick",
                                      "int8-ext.r128.ahead"])
@pytest.mark.parametrize("fault,number", [
    (_state_unchanged, "grid_lo"), (_half_left_out, "grid_cells"),
    (_answer_altered, "det_conf")])
def test_fault_is_not_correct(monkeypatch, fault, number, workload):
    step = core.Program.step

    def broken(self, states, obs):
        new, out = step(self, states, obs)
        return fault(states, new, out)

    monkeypatch.setattr(core.Program, "step", broken)
    r = _run(workload)
    assert not r["correct"] and r["failed"] > 0
    check = r["checks"][number]
    assert check["value"] > check["limit"], r["checks"]


def test_pose_branch_fault_is_not_correct(monkeypatch):
    """Half of the batch left out within the pose branch alone, planted in
    the program where the poses are made: the grid is updated from the
    faulty poses, so only the pose numbers can see it."""
    from grid_vision_tpu_torch import pipeline
    real = pipeline._fleet_vision_poses

    def broken(*args, **kwargs):
        poses, dropped = real(*args, **kwargs)
        return _half_zeroed(poses), dropped

    monkeypatch.setattr(pipeline, "_fleet_vision_poses", broken)
    r = _run("f32-ext.r64.tick")
    assert not r["correct"] and r["failed"] > 0
    c = r["checks"]
    assert c["pose_far"]["value"] > c["pose_far"]["limit"], c
    for number in ("grid_lo", "grid_cells", "pose_slots", "counters"):
        assert c[number]["value"] <= c[number]["limit"], c
