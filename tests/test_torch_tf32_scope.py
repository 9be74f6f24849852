"""device.ieee_convs: the scope that keeps the port's f32 convs out of
TF32. cuDNN's flags are host globals, so the CPU shows what the scope does
to them: inside it cuDNN's f32 conv precision is IEEE; on exit every
reading (the legacy allow_tf32, the conv / RNN / cuDNN precisions,
benchmark, deterministic, the matmul flag) is what it was before, from
every starting state, and a legacy read that did not raise before the
scope does not raise after it."""

import threading

import pytest
import torch

from grid_vision_tpu_torch import device
from grid_vision_tpu_torch.models import orientation_net, yolov4_tiny
from grid_vision_tpu_torch.ops import cuda_csp, cuda_orient, cuda_stem
from grid_vision_tpu_torch.train import trainer

torch.set_num_threads(1)

cudnn = torch.backends.cudnn


def _legacy():
    try:
        return cudnn.allow_tf32
    except RuntimeError:          # a mix of the legacy and new APIs
        return "raises"


def readings():
    return dict(legacy=_legacy(), conv=cudnn.conv.fp32_precision,
                rnn=cudnn.rnn.fp32_precision, cudnn=cudnn.fp32_precision,
                effective_conv=torch._C._get_fp32_precision_getter(
                    "cuda", "conv"),
                benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                matmul=torch.backends.cuda.matmul.allow_tf32)


def _defaults():
    cudnn.allow_tf32 = True


def _legacy_off():
    cudnn.allow_tf32 = False


def _new_api_ieee():
    # the new API on both cuDNN ops, from a process that turned the
    # legacy flag off (so the legacy reading stays consistent: False)
    cudnn.allow_tf32 = False
    cudnn.conv.fp32_precision = "ieee"
    cudnn.rnn.fp32_precision = "ieee"


def _new_api_tf32():
    cudnn.conv.fp32_precision = "tf32"
    cudnn.rnn.fp32_precision = "tf32"


def _new_api_conv_only():
    # conv pinned by the new API alone: the legacy read raises before the
    # scope already, and must do so after it, not be "repaired"
    cudnn.allow_tf32 = True
    cudnn.conv.fp32_precision = "ieee"


def _benchmark_deterministic():
    cudnn.allow_tf32 = True
    cudnn.benchmark = True
    cudnn.deterministic = True


STATES = {"defaults": _defaults, "legacy_off": _legacy_off,
          "new_api_ieee": _new_api_ieee, "new_api_tf32": _new_api_tf32,
          "new_api_conv_only": _new_api_conv_only,
          "benchmark_deterministic": _benchmark_deterministic}


@pytest.fixture(autouse=True)
def restore_flags():
    """Leave the process's flags as torch's defaults after each test."""
    yield
    cudnn.allow_tf32 = True
    cudnn.benchmark = False
    cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("state", list(STATES))
def test_scope_pins_ieee_and_restores_every_reading(state):
    STATES[state]()
    before = readings()
    with device.ieee_convs():
        inside = readings()
    assert readings() == before
    assert inside["effective_conv"] == inside["conv"] == "ieee"
    for key in ("rnn", "benchmark", "deterministic", "matmul"):
        assert inside[key] == before[key]
    if before["legacy"] != "raises":
        assert _legacy() != "raises"


@pytest.mark.parametrize("state", ["defaults", "legacy_off"])
def test_scope_restores_after_an_exception(state):
    STATES[state]()
    before = readings()
    with pytest.raises(KeyError):
        with device.ieee_convs():
            raise KeyError("inside")
    assert readings() == before


def test_nested_scopes_restore_once_at_the_outermost():
    _defaults()
    before = readings()
    with device.ieee_convs():
        with device.ieee_convs():
            pass
        assert cudnn.conv.fp32_precision == "ieee"
    assert readings() == before


def test_threads_share_one_scope():
    """A thread leaving its scope while another is inside keeps IEEE on
    for the other; the last one out restores."""
    _defaults()
    before = readings()
    inside, release, seen = threading.Event(), threading.Event(), []

    def other():
        with device.ieee_convs():
            inside.set()
            release.wait(10)
            seen.append(cudnn.conv.fp32_precision)

    t = threading.Thread(target=other)
    t.start()
    assert inside.wait(10)
    with device.ieee_convs():
        pass
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert seen == ["ieee"]
    assert readings() == before


@pytest.mark.parametrize("state", ["defaults", "legacy_off"])
def test_legacy_api_where_torch_has_no_conv_precision(monkeypatch, state):
    """A torch without cudnn.conv.fp32_precision: the scope turns the
    legacy flag off and restores it."""
    monkeypatch.setattr(device, "_conv_precision_api", lambda: None)
    STATES[state]()
    before = _legacy()
    with device.ieee_convs():
        assert cudnn.allow_tf32 is False
    assert _legacy() == before


@pytest.mark.parametrize("fn", [
    yolov4_tiny.forward, orientation_net.forward,
    cuda_stem.detector_stem_plain, cuda_orient.orient_front_plain,
    cuda_csp.detector_csp_plain])
def test_the_port_forwards_run_in_the_scope(fn, monkeypatch):
    """The nets' forwards and the three kernels' plain twins enter the
    scope once a call (the train step's forward and backward: below)."""
    _defaults()
    seen = []

    def probe(*args, **kwargs):
        seen.append(cudnn.conv.fp32_precision)
        raise StopIteration
    for mod, name in ((yolov4_tiny, "decode"),
                      (cuda_stem, "preprocess_detector_image"),
                      (cuda_orient, "crops_by_rig")):
        monkeypatch.setattr(mod, name, probe)
    model = type("Probe", (), {"__call__": probe, "front": probe})()
    with pytest.raises(StopIteration):
        if fn is cuda_stem.detector_stem_plain:
            fn(torch.zeros(1, 4, 4, 3), {"w0_oihw": torch.zeros(1)}, 4)
        elif fn is cuda_orient.orient_front_plain:
            fn(*[torch.zeros(1)] * 4, model, 4)
        elif fn is cuda_csp.detector_csp_plain:
            fn(torch.zeros(1, 2, 2, 2), model)
        elif fn is yolov4_tiny.forward:
            model.__class__.__call__ = lambda self, *a: (None, None)
            fn(model, torch.zeros(1))
        else:
            fn(model, torch.zeros(1))
    assert seen == ["ieee"]
    assert cudnn.conv.fp32_precision == "tf32"


def test_train_step_forward_and_backward_in_the_scope(monkeypatch):
    """The backward's convs run at loss.backward(), outside any forward:
    the train step holds both in one scope."""
    _defaults()
    seen = []

    class Loss:
        def backward(self):
            seen.append(("backward", cudnn.conv.fp32_precision))

        def detach(self):
            return self

    def loss_fn(model, *batch, train):
        seen.append(("forward", cudnn.conv.fp32_precision))
        return Loss(), ({}, {})

    monkeypatch.setattr(trainer, "_loss_fn", lambda kind, cfg: loss_fn)
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    tx = type("Tx", (), {"lr": staticmethod(lambda step: 0.1)})()
    step = trainer.make_train_step("yolo", None, tx)
    step(trainer.TrainState(model=model, opt=opt), torch.zeros(1))
    assert seen == [("forward", "ieee"), ("backward", "ieee")]
    assert cudnn.conv.fp32_precision == "tf32"
