"""The port's demo (demo.main) against the JAX package's on the CPU, and
the CLI's last three commands: `python -m grid_vision_tpu_torch demo --cpu
--mode pca --det oracle --steps 6` writes the same PGM and PPM bytes as
JAX's demo.main, the same marker lists (same boxes and poses: floats
within 1e-5); view, demo and bench are commands of the CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from grid_vision_tpu import demo as jdemo
from grid_vision_tpu_torch import __main__ as cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def _markers_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], list) and w[k] and isinstance(w[k][0], float):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                           err_msg=k)
            elif isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= 1e-5, k
            else:
                assert g[k] == w[k], k


def test_demo_pca_oracle_matches_jax(tmp_path):
    out, jout = tmp_path / "port", tmp_path / "jax"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "grid_vision_tpu_torch", "demo", "--cpu",
         "--mode", "pca", "--det", "oracle", "--steps", str(STEPS),
         "--out", str(out)], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"steps: {STEPS}" in r.stdout
    jdemo.main(["--cpu", "--mode", "pca", "--det", "oracle", "--steps",
                str(STEPS), "--out", str(jout)])
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == names
    # every 5th tick and the last: 0, 5
    assert [n for n in names if n.endswith(".pgm")] == [
        "grid_000.pgm", "grid_005.pgm"]
    cubes = 0
    for n in names:
        got, want = (out / n).read_bytes(), (jout / n).read_bytes()
        if n.endswith((".pgm", ".ppm")):
            assert got == want, n
        else:
            gm, wm = json.loads(got), json.loads(want)
            _markers_close(gm, wm)
            cubes += sum(m["type"] == "cube" for m in gm)
    assert cubes > 0
    # the printed summary: the same occupied cells
    last = [ln for ln in r.stdout.splitlines() if "occupied" in ln]
    assert last and "occupied cells (p>0.5)" in last[0]


@pytest.mark.parametrize("cmd", ["view", "demo", "bench"])
def test_cli_accepts_view_demo_bench(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    assert f"grid_vision_tpu_torch {cmd}" in capsys.readouterr().out
    assert cmd in cli.__doc__
