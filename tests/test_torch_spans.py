"""The span recorder (grid_vision_tpu_torch/utils/stats.py) in the port's
tick, on the CPU: a small fleet in the f32 compat configuration with the
slice's kernel backends (their plain twins run here), random weights with
the detector heads scaled so boxes clear the threshold, as in
tests/test_torch_fleet.py.

Off, span() is one shared no-op: a tick records nothing, reads no clock
and enters no record_function, even under a profiler. On, a fleet tick
and a single-rig step record step, detect, pose, static and grid once
each, and one sync around each call that blocks the host on a card (an
NMS sweep's test, each copy of host data to the device); the outputs are
bit-equal either way; under a CPU profiler every gv. span nests in
gv.step and every aten op of the tick has a gv. ancestor."""

import dataclasses

import pytest
import torch

from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.runtime.stream import FleetPool
from grid_vision_tpu_torch.utils import stats

R = 3
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, max_static_depth=16,
             detector_stem_backend="pallas2",
             orientation_stem_backend="pallas", grid_backend="pallas",
             knn_backend="pallas")
HEAD_SCALE = 150.0
LAYERS = ("step", "detect", "pose", "static", "grid")


@pytest.fixture(scope="module")
def fleet():
    cfg = GridVisionConfig(**SMALL)
    nets = weights.load_all(cfg, device="cpu")
    with torch.no_grad():
        for head in ("head_13", "head_26"):
            getattr(nets["detector"], head).weight.mul_(HEAD_SCALE)
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    pool = FleetPool(cfg, R, device="cpu")
    return eng, eng.init_states(R), pool.obs(0)


@pytest.fixture(autouse=True)
def clean():
    stats.reset()
    yield
    stats.reset()


@pytest.fixture
def syncs(monkeypatch):
    """The tick's calls that block the host on a card: each NMS sweep's
    torch.equal and each copy of host data to the device (torch.tensor /
    torch.as_tensor given a device; a numpy index is one too). One entry
    a call: whether a gv.sync span was open around it."""
    calls, open_syncs = [], []
    real_span = stats.span

    class Tracked:
        def __init__(self, name):
            self.name, self.inner = name, real_span(name)

        def __enter__(self):
            open_syncs.append(self.name == "sync")
            return self.inner.__enter__()

        def __exit__(self, *exc):
            open_syncs.pop()
            return self.inner.__exit__(*exc)

    def counted(fn, blocks):
        def call(*a, **k):
            if blocks(a, k):
                calls.append(any(open_syncs))
            return fn(*a, **k)
        return call

    def upload(a, k):
        return "device" in k and not isinstance(a[0], torch.Tensor)

    monkeypatch.setattr(stats, "span", Tracked)
    monkeypatch.setattr(torch, "equal", counted(torch.equal,
                                                lambda a, k: True))
    monkeypatch.setattr(torch, "tensor", counted(torch.tensor, upload))
    monkeypatch.setattr(torch, "as_tensor", counted(torch.as_tensor,
                                                    upload))
    return calls


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def test_off_is_one_noop(fleet, monkeypatch):
    eng, states, obs = fleet
    assert stats.span("detect") is stats.span("grid")

    def boom(*a, **k):
        raise AssertionError("entered while the recorder is off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(stats, "_clock", boom)
    eng.fleet(states, obs, 2 * R)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.fleet(states, obs, 2 * R)
    assert stats.snapshot() == {}


def test_fleet_tick_records_each_layer_once(fleet, syncs):
    eng, states, obs = fleet
    with stats.tracing():
        _, out = eng.fleet(states, obs, 2 * R)
    snap = stats.snapshot()
    assert {k: v[0] for k, v in snap.items() if k in LAYERS} == \
        dict.fromkeys(LAYERS, 1)
    assert int(out.boxes.valid.sum()) > 0 and int(out.poses.valid.sum()) > 0
    # one gv.sync a blocking call, each call inside one
    assert snap["sync"][0] == len(syncs) > 1 and all(syncs)
    assert set(snap) == set(LAYERS) | {"sync"}
    assert all(v[1] >= 0.0 for v in snap.values())
    assert snap["step"][1] >= snap["detect"][1] + snap["pose"][1]
    # the setting before comes back
    assert not stats._on


def test_outputs_bit_equal_on_and_off(fleet):
    eng, states, obs = fleet
    off = eng.fleet(states, obs, 2 * R)
    with stats.tracing():
        on = eng.fleet(states, obs, 2 * R)
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_profiler_sees_nested_spans(fleet):
    eng, states, obs = fleet
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stats.tracing():
            eng.fleet(states, obs, 2 * R)
    events = prof.events()
    gv = {e.name: e for e in events if e.name.startswith("gv.")}
    assert set(gv) == {"gv." + k for k in LAYERS} | {"gv.sync"}
    assert gv["gv.step"].cpu_parent is None
    for name in ("gv.detect", "gv.pose", "gv.static", "gv.grid"):
        assert gv[name].cpu_parent is gv["gv.step"]
    # syncs inside the layers (the NMS sweeps in detect) or the step
    parents = [e.cpu_parent for e in events if e.name == "gv.sync"]
    assert all(p is not None and p.name in gv and gv[p.name] is p
               for p in parents)
    assert gv["gv.detect"] in parents

    def spanned(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("gv."):
                return True
            p = p.cpu_parent
        return False

    aten = [e for e in events if e.name.startswith("aten::")]
    assert len(aten) > 100 and all(spanned(e) for e in aten)
    # the host totals count the same calls
    assert stats.snapshot()["step"][0] == 1


def test_single_rig_step_records_the_same(fleet, syncs):
    eng, _, obs = fleet
    state, one = eng.init_state(), obs.select(0)
    syncs.clear()
    with stats.tracing():
        eng(state, one)
    snap = stats.snapshot()
    assert {k: v[0] for k, v in snap.items() if k in LAYERS} == \
        dict.fromkeys(LAYERS, 1)
    assert snap["sync"][0] == len(syncs) > 1 and all(syncs)
