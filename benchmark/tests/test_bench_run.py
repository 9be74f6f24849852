"""run.py prints a result line only where no forbidden module is loaded
after the judge and every metric reader have run: a reader that imports
a module named jax leaves the run without a result, and with a code
other than 0. Run on the CPU at a small size, with the look for a card
answered yes."""

import functools
import importlib
import json
import sys

import pytest
import torch

from benchmark import core, run

PLAIN = {"detector_stem_backend": "xla", "orientation_stem_backend": "xla",
         "grid_backend": "xla", "knn_backend": "xla"}
SMALL = {"rigs": 4, "check_ticks": 2, "chunk": 2}
ARGS = ["--workload", "f32-ext.r64.tick", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


@pytest.fixture
def cpu_run(monkeypatch, tmp_path):
    """run.main on the CPU, the forbidden modules out of sys.modules, a
    package named jax importable from tmp_path; returns the reader hook's
    switch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(core, "run_cell", functools.partial(
        core.run_cell, device="cpu",
        overrides={"engine": PLAIN, "traffic": SMALL}))
    for name in list(sys.modules):
        if core.forbidden_modules([name]):
            monkeypatch.delitem(sys.modules, name)
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    hook = {"import_jax": False}
    real = core.reader

    def reader(name):
        read = real(name)

        def hooked(rec):
            if hook["import_jax"]:
                importlib.import_module("jax")
            return read(rec)
        return hooked

    monkeypatch.setattr(core, "reader", reader)
    yield hook
    sys.modules.pop("jax", None)


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def test_result_line_without_jax(cpu_run, capsys):
    assert run.main(ARGS) == 0
    result = json.loads(_lines(capsys)[-1])
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert list(result)[-1] == "checks"


def test_no_result_line_when_a_reader_loads_jax(cpu_run, capsys):
    cpu_run["import_jax"] = True
    assert run.main(ARGS) != 0
    assert "jax" in sys.modules
    assert not any(ln.lstrip().startswith("{") for ln in _lines(capsys))
