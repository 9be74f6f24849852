"""Build and load the hand-written Hopper kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Nothing here runs at import time: a kernel module asks for its
library at its first launch, so the package imports on machines without a
CUDA toolkit. Builds land in ``build/grid_vision_tpu_torch/`` of the
checkout (git-ignored), keyed by a hash of the source, the headers of
``csrc/`` (``*.cuh``, which any source may include) and the flags, so an
edited source or header rebuilds and an unchanged one loads the cached
library.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them together — the way ``chip_smoke.py`` builds every kernel. A variant
is a source built with ``-D`` macros (a measurement build, e.g. phase
clocks) into a library of its own, beside the plain one: ``load(name,
macros)``.
``consts_dtype`` and ``check_constants`` are the wrappers' shared checks of
the folded constants a kernel form reads (f32, or bf16 since the bf16
forms).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "grid_vision_tpu_torch"
SOURCES = ("cuda_csp", "cuda_csp_bf16", "cuda_grid", "cuda_int8", "cuda_knn",
           "cuda_orient", "cuda_orient_bf16", "cuda_raycast", "cuda_stem",
           "cuda_stem_bf16")

# No --use_fast_math: the grid and carve kernels' log-odds must be bit-equal
# to their plain torch twins (IEEE expf / division, explicit _rn intrinsics).
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "grid_vision_tpu_torch kernels build with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str, macros: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _defines(macros)).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _defines(macros: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(f"-D{m}" for m in macros)


def _start(name: str, macros: Tuple[str, ...] = ()):
    """Start nvcc for one source (None when its library is cached)."""
    out = _lib_path(name, macros)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *_defines(macros), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(key: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    ptxas_log[key] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{key}:\n{log}")
    os.replace(tmp, out)


def _key(name: str, macros: Tuple[str, ...]) -> str:
    return ":".join((name,) + tuple(macros)) if macros else name


def build_all(names: Iterable[str] = SOURCES,
              variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """Compile every missing library, one nvcc process per source (and per
    variant: a source and its macros), all started together. ptxas_log
    keys a variant's log as SOURCE:MACRO[:MACRO...]."""
    builds = [(n, ()) for n in names] + [(n, tuple(m)) for n, m in variants]
    with _lock:
        started = {b: _start(*b) for b in builds}
        errors = []
        for b in builds:
            try:
                _finish(_key(*b), started[b])
            except RuntimeError as e:      # reap every process first
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str, macros: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built with -D for each of
    `macros`), built on first use."""
    key = (name, tuple(macros))
    lib = _libs.get(key)
    if lib is None:
        if macros:
            build_all([], [key])
        else:
            build_all([name])
        lib = ctypes.CDLL(str(_lib_path(*key)))
        _libs[key] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def consts_dtype(consts) -> torch.dtype:
    """The form a kernel's folded constants are for: f32 unless marked
    (prepare_*_constants(..., torch.bfloat16) marks the bf16 form's)."""
    return consts.get("dtype", torch.float32)


def check_constants(consts, shapes, dev, what: str) -> None:
    """Raise unless every constant a kernel reads is a contiguous tensor of
    its shape (and dtype: f32 where `shapes` gives a shape alone) on
    `dev`."""
    for name, spec in shapes.items():
        shape, dtype = (spec if isinstance(spec[-1], torch.dtype)
                        else (spec, torch.float32))
        t = consts[name]
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what} constant {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {dev}")
