"""The slice as a whole, orientation side: each package's `train
orientation` CLI at a tiny size (--cpu --steps 4 --scan 2 --batch 8
--input-size 32 --width 8, 4 metric scene crops). Both run to their end and
print their angle and dims recovery; the saved files hold the same keys,
shapes and dtypes; each package's load_all reads the other's file; the
first losses agree to 2e-2."""

import re

import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.train import fit_orientation as jfit
from grid_vision_tpu_torch.__main__ import main as cli
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights

torch.set_num_threads(1)

ARGS = ["--cpu", "--steps", "4", "--scan", "2", "--batch", "8",
        "--input-size", "32", "--width", "8", "--scene-crops", "4"]


def test_train_orientation_cli_both_packages(tmp_path, capsys):
    port_out, jax_out = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    cli(["train", "orientation", *ARGS, "--out", port_out])
    port_log = capsys.readouterr().out
    jfit.main([*ARGS, "--out", jax_out])
    jax_log = capsys.readouterr().out
    for log, path in ((port_log, port_out), (jax_log, jax_out)):
        assert "steps 2-3: loss" in log
        assert f"saved orientation weights -> {path}" in log
        assert "angle recovery: median" in log and "dims recovery" in log
    with np.load(port_out) as p, np.load(jax_out) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].shape == j[k].shape and p[k].dtype == j[k].dtype, k
    first = [float(re.search(r"steps 0-1: loss ([\d.]+)", log).group(1))
             for log in (port_log, jax_log)]
    np.testing.assert_allclose(*first, rtol=2e-2)
    kw = dict(network_height=32, network_width=32, orientation_width=8)
    mine = weights.load_all(GridVisionConfig(**kw,
                                             vision_weights_file=port_out),
                            device="cpu")["orientation"].state_dict()
    jback = jweights.load_all(JaxConfig(**kw, vision_weights_file=port_out))
    jflat = weights.params_from_jax(jback["orientation"])
    for k, v in mine.items():
        np.testing.assert_array_equal(jflat[k].numpy(), v.numpy(), err_msg=k)
    back = weights.load_all(GridVisionConfig(**kw,
                                             vision_weights_file=jax_out),
                            device="cpu")["orientation"].state_dict()
    with np.load(jax_out) as j:
        want = weights.params_from_jax(
            weights.checkpoint.flat_to_tree({k: j[k] for k in j.files}))
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_resnet_arch_is_refused(tmp_path, capsys):
    """`train orientation --arch resnet` runs (the ResNet-18 net, its
    train-mode BatchNorm in the ResBlocks) and saves the JAX package's tree
    of that arch, which both packages' load_all read back. The test
    keeps the name it had when the port refused the resnet arch."""
    out = str(tmp_path / "r.npz")
    cli(["train", "orientation", *ARGS, "--arch", "resnet", "--out", out])
    log = capsys.readouterr().out
    assert "steps 2-3: loss" in log and "angle recovery: median" in log
    kw = dict(network_height=32, network_width=32, orientation_width=8,
              orientation_arch="resnet", vision_weights_file=out)
    mine = weights.load_all(GridVisionConfig(**kw), device="cpu")
    assert type(mine["orientation"]).__name__ == "OrientationNet"
    jback = jweights.load_all(JaxConfig(**kw))
    jflat = weights.params_from_jax(jback["orientation"])
    for k, v in mine["orientation"].state_dict().items():
        np.testing.assert_array_equal(jflat[k].numpy(), v.numpy(), err_msg=k)
