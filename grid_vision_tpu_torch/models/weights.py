"""Model weights: flax parameter trees <-> the port's modules.

The JAX package keeps weights as flax trees ``{"params": ..., "batch_stats":
...}`` and ships them as flat npz files (weights/detector.npz,
weights/orientation.npz). ``params_from_jax`` maps such a tree, held as
numpy arrays, onto a module's state dict: the port's modules carry the
flax names, so a path maps to a key one to one. Conv kernels go HWIO ->
OIHW, Dense kernels (in, out) -> Linear weights (out, in), BatchNorm scale
-> weight and batch_stats mean / var -> running_mean / running_var;
``flax_tree`` is the inverse. Reference-format ``.onnx`` detector weights
import through ``onnx_import`` onto that tree. ``init_all`` is the JAX
package's random init (flax's, from the same seed, leaf for leaf) and
``save_all`` writes the JAX package's npz files, which either package's
``load_all`` reads.

The detector is the configured architecture (``detector_arch``):
YOLOv4-tiny, or YOLOv4 (models/yolov4.py), which has no JAX twin. A
YOLOv4 detector file may hold a weights recipe in place of the weights
(``['params']['recipe'][...]``, weights/yolov4_seeded.npz): a seed and a
few gains and biases that ``expand_yolov4_recipe`` turns into every
weight on load (the ~64 M parameters would not fit the repository).
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
from ..utils import checkpoint, prng
from . import layers
from . import (onnx_import, orientation_net, yolov4, yolov4_int8,
               yolov4_tiny)

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


def detector_config(cfg: GridVisionConfig):
    """The configured detector's YoloConfig (YOLOv4-tiny) or YoloV4Config
    (YOLOv4)."""
    if cfg.detector_arch == "yolov4":
        return yolov4.YoloV4Config(input_size=cfg.resize)
    return yolov4_tiny.YoloConfig(input_size=cfg.resize)


def detector_model(cfg: GridVisionConfig) -> nn.Module:
    """The configured detector architecture, its parameters unset."""
    if cfg.detector_arch == "yolov4":
        return yolov4.YoloV4(detector_config(cfg))
    return yolov4_tiny.YoloV4Tiny(detector_config(cfg))


# ------------------------------------------------------- the YOLOv4 recipe

def expand_yolov4_recipe(recipe: Dict[str, Any],
                         num_classes: int = 10) -> Dict[str, Any]:
    """A YOLOv4 weights recipe -> the flax tree {"params", "batch_stats"}
    of numpy float32 arrays that it stands for.

    The recipe (float32 values): seed (an integer below 2^24), mish_gain
    and leaky_gain (the ConvBN kernels' gains by activation), bn_spread,
    res_scale, box_gain and logit_gain (the heads' kernel gains), obj_bias
    (3,) (each head's objectness bias, stride 8 first) and cls_bias (C,).

    The order (the plain reference, benchmark/detectors/yolov4.py, expands
    the same recipe in the same order, bit for bit): one
    numpy.random.default_rng(seed); then for each of the 110 convs in cfg
    order (models/yolov4.conv_specs: ConvBN_0 .. ConvBN_92, head_52,
    ConvBN_93 .. ConvBN_99, head_26, ConvBN_100 .. ConvBN_106, head_13):

      z = standard_normal((c_out, c_in, k, k), float32)   (OIHW)
      a ConvBN: kernel = z * g, g = float32(gain) / sqrt(float32(c_in k k))
        in float32, gain mish_gain or leaky_gain by the block's activation;
        then u = standard_normal((4, c_out), float32) and
          scale = 1 + bn_spread * u[0] (times res_scale for the ConvBN that
                  ends a residual branch, yolov4.residual_ends),
          bias  = bn_spread * u[1],
          mean  = bn_spread * u[2],
          var   = exp(bn_spread * u[3]),
        each in float32: statistics away from the identity, so that a fault
        in the fold shows;
      a head: kernel = z * g[:, None, None, None], g per output row:
        float32(box_gain) / sqrt(float32(c_in)) for the four box channels of
        each anchor, float32(logit_gain) / sqrt(float32(c_in)) for its
        objectness and class channels; bias: 0 for the box channels,
        obj_bias[head] for the objectness, cls_bias for the classes (no
        draw).
    """
    r = {k: np.asarray(v, np.float32) for k, v in recipe.items()}
    rng = np.random.default_rng(int(r["seed"]))
    spread = r["bn_spread"]
    one = np.float32(1.0)
    ends = set(yolov4.residual_ends(num_classes))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    head = 0
    for name, c_in, c_out, k, _, act, _ in yolov4.conv_specs(num_classes):
        z = rng.standard_normal((c_out, c_in, k, k), dtype=np.float32)
        if act == "linear":
            j = np.arange(c_out) % (5 + num_classes)
            root = np.sqrt(np.float32(c_in), dtype=np.float32)
            g = np.where(j < 4, r["box_gain"] / root,
                         r["logit_gain"] / root).astype(np.float32)
            bias = np.zeros(c_out, np.float32)
            bias[j == 4] = r["obj_bias"][head]
            bias[j >= 5] = np.tile(r["cls_bias"], 3)
            head += 1
            params[name] = {"kernel": (z * g[:, None, None, None])
                            .transpose(2, 3, 1, 0), "bias": bias}
            continue
        gain = r["mish_gain"] if act == "mish" else r["leaky_gain"]
        g = gain / np.sqrt(np.float32(c_in * k * k), dtype=np.float32)
        u = rng.standard_normal((4, c_out), dtype=np.float32)
        scale = one + spread * u[0]
        if name in ends:
            scale = scale * r["res_scale"]
        params[name] = {"Conv_0": {"kernel": (z * g).transpose(2, 3, 1, 0)},
                        "BatchNorm_0": {"scale": scale,
                                        "bias": spread * u[1]}}
        stats[name] = {"BatchNorm_0": {"mean": spread * u[2],
                                       "var": np.exp(spread * u[3])}}
    return {"params": params, "batch_stats": stats}


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


def _init_keys(seed: int, device) -> Dict[str, torch.Tensor]:
    """The JAX package's init keys: split(PRNGKey(seed)) -> detector,
    orientation."""
    kd, ko = prng.split(prng.prng_key(seed, device=device))
    return {"detector": kd, "orientation": ko}


def _init_net(key: str, cfg: GridVisionConfig, rng: torch.Tensor):
    if key == "detector":
        if cfg.detector_arch == "yolov4":
            return layers.flax_init(detector_model(cfg).to(rng.device), rng)
        return yolov4_tiny.init_params(rng, detector_config(cfg))
    return orientation_net.init_params(rng, orientation_config(cfg))


def init_all(cfg: GridVisionConfig, seed: int = 0,
             device="cuda") -> Dict[str, nn.Module]:
    """{"detector", "orientation"} with the JAX package's random init
    (grid_vision_tpu/models/weights.init_all: flax's init of each net from
    split(PRNGKey(seed))), on `device` (the card unless the CPU is asked
    for), eval mode. The detector is the configured architecture; YOLOv4
    takes flax's init of its tree from the same key (layers.flax_init)."""
    device = resolve_device(device)
    keys = _init_keys(seed, device)
    return {k: _init_net(k, cfg, keys[k]).eval() for k in keys}


def save_all(params: Dict[str, nn.Module], cfg: GridVisionConfig,
             base_dir: str = ".") -> None:
    """Write both nets as the JAX package's flat npz checkpoints at the
    configured paths (weights/detector.npz and weights/orientation.npz
    where none is configured; a leading '/' is relative to base_dir, and
    ".npz" is appended where missing), which either package's load_all
    reads."""
    for key, rel, default in (
            ("detector", cfg.detection_weights_file, "weights/detector.npz"),
            ("orientation", cfg.vision_weights_file,
             "weights/orientation.npz")):
        path = os.path.join(base_dir, (rel or default).lstrip("/"))
        if not path.endswith(".npz"):
            path += ".npz"
        checkpoint.save_npz_tree(path, flax_tree(params[key]))


def load_all(cfg: GridVisionConfig, base_dir: str = ".", seed: int = 0,
             device="cuda") -> Dict[str, Any]:
    """{"detector": the detector_arch's net (YoloV4Tiny or YoloV4),
    "orientation": the orientation_arch's net} on `device` (the card
    unless the CPU is asked for), eval mode, and with
    detector_precision="int8" "detector_q", the detector quantized by
    yolov4_int8.quantize_detector (the JAX package's load_all). Configured
    npz files load (a YOLOv4 weights recipe expanded by
    expand_yolov4_recipe), and a YOLOv4-tiny detector file ending in .onnx
    (the reference node's own format) is imported by
    onnx_import.import_yolov4_tiny; a net with no file configured, or a
    missing file (with a WARNING), gets the JAX package's random init from
    `seed` (init_all's)."""
    device = resolve_device(device)
    keys = _init_keys(seed, device)
    nets = {}
    for key, rel in (("detector", cfg.detection_weights_file),
                     ("orientation", cfg.vision_weights_file)):
        path = _resolve(base_dir, rel, key == "detector") if rel else None
        if path is not None and os.path.exists(path):
            net = (detector_model(cfg) if key == "detector" else
                   orientation_net.make_model(orientation_config(cfg)))
            if path.endswith(".onnx"):
                if cfg.detector_arch != "yolov4-tiny":
                    raise ValueError(f"no .onnx import for detector_arch "
                                     f"{cfg.detector_arch!r}: {path}")
                tree = onnx_import.import_yolov4_tiny(path, flax_tree(net))
            else:
                tree = checkpoint.load_npz_tree(path)
                if "recipe" in tree.get("params", {}):
                    tree = expand_yolov4_recipe(
                        tree["params"]["recipe"],
                        detector_config(cfg).num_classes)
            nets[key] = load_module(net, tree).to(device)
        else:
            if rel:
                logger.warning("configured %s weights %r not found; using "
                               "random init", key, rel)
            nets[key] = _init_net(key, cfg, keys[key])
    params: Dict[str, Any] = {k: m.eval() for k, m in nets.items()}
    if cfg.detector_precision == "int8":
        params["detector_q"] = yolov4_int8.quantize_detector(
            params["detector"])
    return params
