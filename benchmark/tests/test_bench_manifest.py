"""BENCHMARK.json and every configuration, traffic mix, limits file and
metric reader it names load by name and keep to the benchmark's contract;
the no-JAX check compares whole top-level module names."""

import json
import os
import re

import pytest

from benchmark import core, judge
from benchmark.counts import PEAKS

ROOT = core.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"][:2] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in manifest[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(manifest, kind):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest[kind]:
        assert set(m.get("workloads", [])) <= cells
        assert callable(core.reader(m["name"]))
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            moved = e2e[m["moves"]]
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
            if m["name"].endswith("_roofline"):
                assert m["unit"] == "%"


def test_cells_load_by_name(manifest):
    for w in manifest["workloads"]:
        _, cell, config, traffic, limits = core.load_cell(w["name"])
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        assert traffic["loop"] in ("ahead", "tick")
        assert set(limits) - {"why", "pose_far_gap"} <= set(judge.NUMBERS)
        assert ("pose_far" in limits) == ("pose_far_gap" in limits)
        # every number of the judge: its limit's readings, or why it is
        # not compared
        assert set(judge.NUMBERS) <= set(limits["why"])
        assert config["name"] == cell["config"]
        assert config["peak"] in PEAKS
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        for kind, least in (("end_to_end", 2), ("per_layer", 1)):
            assert len(core.metrics_of(manifest, w["name"], kind)) >= least


def test_configs(manifest):
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"] + ["why"])
        for key, (old, new) in cfg["departures"].items():
            assert cfg["engine"][key] == new
        from grid_vision_tpu_torch.config import GridVisionConfig
        GridVisionConfig(**cfg["engine"]).validate()


@pytest.mark.parametrize("names,found", [
    (["grid_vision_tpu_torch", "grid_vision_tpu_torch.pipeline", "torch"],
     []),
    (["grid_vision_tpu.ops"], ["grid_vision_tpu"]),
    (["jaxlib.xla_client", "numpy"], ["jaxlib"]),
    (["flax", "optax.transforms", "jax"], ["flax", "jax", "optax"]),
    (["jaxtyping", "flaxen"], []),
])
def test_forbidden_modules(names, found):
    assert core.forbidden_modules(names) == found


def test_detector_keys(manifest):
    """A configuration's "detector" names a module under
    benchmark/detectors/ with detect_dense and detector_ops."""
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        if "detector" not in cfg:
            continue
        assert cfg["detector"].startswith("benchmark/detectors/")
        det = core.detector(cfg)
        assert callable(det.detect_dense) and callable(det.detector_ops)
