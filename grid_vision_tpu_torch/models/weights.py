"""Model weights: flax parameter trees -> the port's modules.

The JAX package keeps weights as flax trees ``{"params": ..., "batch_stats":
...}`` and ships them as flat npz files (weights/detector.npz,
weights/orientation.npz). ``params_from_jax`` maps such a tree, held as
numpy arrays, onto a module's state dict: the port's modules carry the
flax names, so a path maps to a key one to one. Conv kernels go HWIO ->
OIHW, Dense kernels (in, out) -> Linear weights (out, in), BatchNorm scale
-> weight and batch_stats mean / var -> running_mean / running_var;
``flax_tree`` is the inverse. Reference-format ``.onnx`` detector weights
import through ``onnx_import`` onto that tree.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..config import GridVisionConfig
from ..device import resolve_device
from ..utils import checkpoint
from . import onnx_import, orientation_net, yolov4_tiny

logger = logging.getLogger("grid_vision_tpu_torch.weights")

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaf(path, value: np.ndarray):
    """One flax leaf -> (state-dict key, tensor)."""
    *mods, name = path
    arr = np.asarray(value, np.float32)
    if name == "kernel":
        name = "weight"
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)           # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T                               # (in, out) -> (out, in)
    elif name == "scale":
        name = "weight"
    elif name in _STATS:
        name = _STATS[name]
    return ".".join([*mods, name]), torch.from_numpy(np.array(arr))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables {"params": ..., "batch_stats": ...} of numpy arrays
    -> a state dict for the port's module of the same architecture."""
    flat = checkpoint.tree_to_flat(tree)
    out = {}
    for key, value in flat.items():
        path = checkpoint.split_key(key)
        if path[0] not in ("params", "batch_stats"):
            raise KeyError(f"unexpected collection in {key!r}")
        k, t = _leaf(path[1:], value)
        out[k] = t
    return out


def flax_tree(module: nn.Module) -> Dict[str, Any]:
    """The inverse of params_from_jax: a module's state dict as a flax
    variables tree {"params": ..., "batch_stats": ...} of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        *mods, name = key.split(".")
        arr = t.detach().cpu().numpy()
        col = "params"
        if name == "weight":
            if arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)  # -> HWIO
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T                # -> (in, out)
            else:
                name = "scale"
        elif name in ("running_mean", "running_var"):
            col, name = "batch_stats", name[len("running_"):]
        node = tree.setdefault(col, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def load_module(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Load a flax tree into `module`; every leaf must land (strict)."""
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module


def _init_random(module: nn.Module, generator: torch.Generator) -> None:
    """Deterministic random init from `generator`: lecun-normal conv and
    linear weights (flax's default), zero biases, identity BatchNorm."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator)
                        / np.sqrt(fan_in))
            elif name.endswith("BatchNorm_0.weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def detector_config(cfg: GridVisionConfig) -> yolov4_tiny.YoloConfig:
    return yolov4_tiny.YoloConfig(input_size=cfg.resize)


def orientation_config(cfg: GridVisionConfig):
    return orientation_net.OrientationConfig(
        input_size=cfg.network_height, width=cfg.orientation_width,
        arch=cfg.orientation_arch, s2d_fold=cfg.orientation_s2d_fold)


def _resolve(base_dir: str, rel: str, onnx: bool) -> str:
    """An existing absolute path wins; a leading '/' otherwise means
    relative to base_dir (the YAML convention of the JAX package). Then, as
    the JAX package's load_all does, a path that does not end in .npz gets
    it appended, but for a detector's .onnx file (onnx=True)."""
    path = rel if os.path.isabs(rel) and os.path.exists(rel) else \
        os.path.join(base_dir, rel.lstrip("/"))
    if path.endswith(".npz") or (onnx and path.endswith(".onnx")):
        return path
    return path + ".npz"


def load_all(cfg: GridVisionConfig, base_dir: str = ".", seed: int = 0,
             device="cuda") -> Dict[str, nn.Module]:
    """{"detector": YoloV4Tiny, "orientation": OrientationNetS2D} on
    `device` (the card unless the CPU is asked for), eval mode. Configured
    npz files load, and a detector file ending in .onnx (the reference
    node's own format) is imported by onnx_import.import_yolov4_tiny; a net
    with no file configured, or a missing file (with a WARNING), gets a
    deterministic random init from a torch.Generator seeded with `seed`
    (not the JAX package's flax init: its random weights differ)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    nets = {"detector": yolov4_tiny.YoloV4Tiny(detector_config(cfg)),
            "orientation": orientation_net.OrientationNetS2D(
                orientation_config(cfg))}
    for key, rel in (("detector", cfg.detection_weights_file),
                     ("orientation", cfg.vision_weights_file)):
        path = _resolve(base_dir, rel, key == "detector") if rel else None
        if path is not None and os.path.exists(path):
            if path.endswith(".onnx"):
                tree = onnx_import.import_yolov4_tiny(
                    path, flax_tree(nets[key]))
            else:
                tree = checkpoint.load_npz_tree(path)
            load_module(nets[key], tree)
        else:
            if rel:
                logger.warning("configured %s weights %r not found; using "
                               "random init", key, rel)
            _init_random(nets[key], gen)
    return {k: m.to(device).eval() for k, m in nets.items()}
