"""The slice as a whole: each package's `train detector` CLI at a tiny size
(--cpu --steps 4 --scan 2 --batch 2 --input-size 32). Both run to their
end; the saved files hold the same keys, shapes and dtypes; each package's
load_all reads the other's file; the first losses agree to 2e-2 (both
train in bf16 from the same flax init on the same first batch)."""

import re

import numpy as np
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.train import fit_on_device as jfit
from grid_vision_tpu_torch.__main__ import main as cli
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights

torch.set_num_threads(1)

ARGS = ["--cpu", "--steps", "4", "--scan", "2", "--batch", "2",
        "--input-size", "32"]


def _first_loss(out: str) -> float:
    return float(re.search(r"steps 0-1: loss ([\d.]+)", out).group(1))


def test_train_detector_cli_both_packages(tmp_path, capsys):
    port_out, jax_out = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    cli(["train", "detector", *ARGS, "--out", port_out])
    port_log = capsys.readouterr().out
    jfit.main([*ARGS, "--out", jax_out])
    jax_log = capsys.readouterr().out
    for log, path in ((port_log, port_out), (jax_log, jax_out)):
        assert "steps 2-3: loss" in log
        assert f"saved detector weights -> {path}" in log
    with np.load(port_out) as p, np.load(jax_out) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].shape == j[k].shape and p[k].dtype == j[k].dtype, k
    np.testing.assert_allclose(_first_loss(port_log), _first_loss(jax_log),
                               rtol=2e-2)
    kw = dict(detection_network_input_size=32)
    back = weights.load_all(GridVisionConfig(**kw,
                                             detection_weights_file=jax_out),
                            device="cpu")["detector"].state_dict()
    mine = weights.load_all(GridVisionConfig(**kw,
                                             detection_weights_file=port_out),
                            device="cpu")["detector"].state_dict()
    jback = jweights.load_all(JaxConfig(**kw,
                                        detection_weights_file=port_out))
    assert back.keys() == mine.keys()
    jflat = weights.params_from_jax(jback["detector"])
    for k, v in mine.items():
        np.testing.assert_array_equal(jflat[k].numpy(), v.numpy(), err_msg=k)
    with np.load(jax_out) as j:
        want = weights.params_from_jax(
            weights.checkpoint.flat_to_tree({k: j[k] for k in j.files}))
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
