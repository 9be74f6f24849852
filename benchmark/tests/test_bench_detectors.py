"""A configuration may bring its own detector (benchmark/detectors/, its
"detector" key):

  - the three cells that name none judge, control and count exactly as
    before: core.detector gives reference.py's own functions, and the
    judge's numbers and the control's tick are bit for bit those of the
    calls without it;
  - a throwaway configuration that only adds files (a detector module,
    its configuration, cell, traffic and limits in a copy of the
    benchmark's data) runs through run_cell;
  - the int8 detector's plain reference (detectors/yolov4tiny_int8.py)
    matches the port's int8 detector on the CPU;
  - detector modules import nothing of the program.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import core, counts, judge, reference as ref

PLAIN = {"detector_stem_backend": "xla", "orientation_stem_backend": "xla",
         "grid_backend": "xla", "knn_backend": "xla"}
INT8 = os.path.join(core.ROOT, "benchmark", "detectors", "yolov4tiny_int8.py")
SEED = 2 ** 31 + 41


def _tick(workload, rigs=2):
    """One program tick of the cell at `rigs` rigs on the CPU's plain
    path: (config, traffic budget, sample)."""
    _, _, config, traffic, _ = core.load_cell(workload)
    config = dict(config, engine=dict(config["engine"], **PLAIN))
    traffic = dict(traffic, rigs=rigs)
    pool, _ = core.build_pool(torch, config, traffic, SEED, "cpu")
    prog = core.Program(torch, config, rigs, "cpu")
    states = prog.init_states(rigs)
    bright, jitter = core.draw(torch, torch.Generator().manual_seed(3), 1,
                               rigs, "cpu")
    obs = core.perturbed(pool, bright[0], jitter[0])
    new, out = prog.step(states, obs)
    budget = config["orientation_budget_per_rig"] * rigs
    return config, budget, types.SimpleNamespace(obs=obs, pre=states,
                                                 post=new, out=out)


@pytest.mark.parametrize("workload", ["bf16-fleet.r128.ahead",
                                      "f32-ext.r64.tick",
                                      "bf16-fleet.r256.ahead"])
def test_existing_cells_unchanged(workload):
    config, budget, sample = _tick(workload)
    assert "detector" not in config
    det = core.detector(config)
    assert det.detect_dense is ref.detect_dense
    assert det.detector_ops is counts.detector_ops
    c = config["engine"]
    nets = core.weights(config, "cpu")
    eye = torch.eye(4)
    want, want_gaps = judge.judge(nets, sample, c, budget, eye, eye)
    got, gaps = judge.judge(nets, sample, c, budget, eye, eye,
                            det.detect_dense)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert torch.equal(want_gaps, gaps)
    # the control's tick: the default detector against core.detector's
    ctrl = core.Control(torch, config, 2, "cpu", config["control"])
    assert ctrl.detect is ref.detect_dense
    _, a = ref.fleet_tick(ctrl.nets, sample.pre, sample.obs, c, budget, eye,
                          eye)
    _, b = ctrl.step(sample.pre, sample.obs)
    for k in ("xyxy", "confidence", "label", "valid"):
        assert torch.equal(getattr(a.boxes, k), getattr(b.boxes, k))
    assert torch.equal(a.poses.position, b.poses.position)
    assert torch.equal(a.occupancy_i8, b.occupancy_i8)
    # step.mfu counts the tiny net's operations, as before
    rec = types.SimpleNamespace(
        config=config, frames=640, window_s=0.35,
        peak_ops=counts.PEAKS[config["peak"]],
        ticks=[{"counts": np.array([8, 3, 0])}] * 10)
    want_mfu = (640 * counts.detector_ops(416) + 30 * counts.orientation_ops(
        224, 32)) / 0.35 / rec.peak_ops * 100
    assert core.reader("step.mfu")(rec) == pytest.approx(want_mfu, rel=1e-12)


THROWAWAY = '''"""A throwaway detector for a test: YOLOv4-tiny in float, each call
counted."""

from benchmark import counts, reference

CALLS = []


def detect_dense(nets, images, size):
    CALLS.append(images.shape[0])
    return reference.detect_dense(nets, images, size)


def detector_ops(size):
    return counts.detector_ops(size)
'''


def test_throwaway_detector_runs(tmp_path, monkeypatch):
    """A copy of the benchmark's data files plus new files only: a
    configuration naming a detector module, the module, a cell, its
    traffic and its limits. run_cell reads them there (core.HERE and
    load_cell's root pointed at the copy) and judges by the module."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(core.HERE, sub), bench / sub)
    (bench / "detectors").mkdir()
    module = bench / "detectors" / "throwaway.py"
    module.write_text(THROWAWAY)
    with open(bench / "configs" / "yolov4tiny-f32-ext.json") as f:
        config = json.load(f)
    # the module's path as os.path.join(core.ROOT, path) leaves it
    config.update(name="throwaway", detector=str(module))
    (bench / "configs" / "throwaway.json").write_text(json.dumps(config))
    (bench / "traffic" / "r2.tick.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "r64.tick.json").read_text()),
             rigs=2, check_ticks=2)))
    shutil.copy(bench / "limits" / "f32-ext.r64.tick.json",
                bench / "limits" / "throwaway.r2.tick.json")
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "throwaway",
                                "file": "benchmark/configs/throwaway.json"})
    manifest["workloads"].append({"name": "throwaway.r2.tick",
                                  "config": "throwaway",
                                  "traffic": "r2.tick", "chips": 1})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    load = core.load_cell
    monkeypatch.setattr(core, "HERE", str(bench))
    monkeypatch.setattr(core, "load_cell", lambda w: load(w, str(tmp_path)))
    r = core.run_cell("throwaway.r2.tick", SEED, 3.0, False, device="cpu",
                      overrides={"engine": PLAIN}, log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 4
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert core.detector(config).CALLS


def test_int8_reference_matches_the_port():
    """Exact on the CPU, tolerance 0: both sides fold and quantize the
    weights in f32 numpy with the same steps, sum the integer codes exactly
    in float64, requantize in float64 rounded to f32, and run the heads
    and the decode as the same f32 torch ops on the same device. On the
    card the heads' convs and the resize's products may pick other
    kernels than the program's, an ulp apart; the judge's limits
    (limits/int8-ext.r128.ahead.json) hold that."""
    from grid_vision_tpu_torch.config import GridVisionConfig
    from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
    from grid_vision_tpu_torch.ops import preprocess
    det = core._detector_module(INT8)
    nets = ref.Nets(os.path.join(core.ROOT, "weights", "detector.npz"),
                    os.path.join(core.ROOT, "weights", "orientation.npz"),
                    "cpu")
    cfg = GridVisionConfig(
        detection_weights_file="weights/detector.npz",
        vision_weights_file="weights/orientation.npz", compat=False,
        detector_precision="int8")
    params = weights.load_all(cfg, base_dir=core.ROOT, device="cpu")
    q = params["detector_q"]
    for name, (wq, sw, b) in det.quantize(nets.det, 127).items():
        assert torch.equal(wq, q[name]["wq"].double()), name
        assert torch.equal(sw, q[name]["sw"]) and torch.equal(b, q[name]["b"])
    gen = torch.Generator().manual_seed(SEED)
    images = torch.rand((2, 120, 160, 3), generator=gen) * 255.0
    size = 224
    boxes, confs = det.detect_dense(nets, images, size)
    net_in = torch.stack([preprocess.preprocess_detector_image(im, size)
                          for im in images])
    want_b, want_c = yolov4_int8.forward_int8(
        q, net_in, yolov4_tiny.YoloConfig(input_size=size))
    assert torch.equal(boxes, want_b) and torch.equal(confs, want_c)
    # the controls read otherwise: the float net, and int4
    _, float_c = ref.detect_dense(nets, images, size)
    assert (float_c - confs).abs().max() > 1e-3
    int4, rounding = det.control("int4")
    nets4 = ref.Nets(os.path.join(core.ROOT, "weights", "detector.npz"),
                     os.path.join(core.ROOT, "weights", "orientation.npz"),
                     "cpu", rounding)
    _, int4_c = int4(nets4, images, size)
    assert (int4_c - confs).abs().max() > 1e-2
    assert det.detector_ops(416) == counts.detector_ops(416)


def test_detector_modules_import_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import core\n"
        "import glob, os\n"
        "for p in glob.glob(os.path.join(core.HERE, 'detectors', '*.py')):\n"
        "    core.detector({'detector': p})\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('grid_vision_tpu_torch',) + core.FORBIDDEN]\n"
        "print(sorted(bad))\n" % core.ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
