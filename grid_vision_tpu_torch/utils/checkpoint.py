"""Flat npz checkpoints keyed by tree paths (the format the JAX package's
utils/checkpoint.save writes for ``*.npz``). Weights: each key is the
flax tree path with every part in brackets, e.g.
``['params']/['ConvBN_0']/['Conv_0']/['kernel']`` (load_npz_tree /
save_npz_tree). Any tree of tensors, e.g. a fleet's GridState (save /
restore): a dataclass field is ``.name``, so a GridState's keys are
``.log_odds``, ``.occupancy``, ``.rng`` and ``.step``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict

import numpy as np
import torch

_PART = re.compile(r"\['([^']*)'\]")


def split_key(key: str):
    parts = _PART.findall(key)
    if "/".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a flax tree path key: {key!r}")
    return parts


def flat_to_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{path key: array} -> nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *head, leaf = split_key(key)
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree


def tree_to_flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {path key: array} (the inverse of flat_to_tree)."""
    out = {}
    for name, value in tree.items():
        key = f"{prefix}/['{name}']" if prefix else f"['{name}']"
        if isinstance(value, dict):
            out.update(tree_to_flat(value, key))
        else:
            out[key] = np.asarray(value)
    return out


def load_npz_tree(path: str) -> Dict[str, Any]:
    """Read a flat npz checkpoint into a nested dict of numpy arrays."""
    with np.load(path) as data:
        return flat_to_tree({k: data[k] for k in data.files})


def save_npz_tree(path: str, tree: Dict[str, Any]) -> None:
    """Write a nested dict of arrays as a flat npz checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **tree_to_flat(tree))


# ---------------------------------------------------------------------------
# Any tree of tensors (the JAX package's utils/checkpoint.save / restore)
# ---------------------------------------------------------------------------

def _map(fn, tree, prefix: str = ""):
    """`tree` with each leaf replaced by fn(key, leaf), for a tree of
    dataclasses, dicts, lists / tuples and tensors or arrays. The key is
    the JAX package's checkpoint key of the leaf's pytree path: the parts
    joined by "/", a dataclass field ".name", a dict entry "['key']", a
    sequence item "[i]" (GridState: ".log_odds", ".occupancy", ".rng",
    ".step")."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: _map(fn, getattr(tree, f.name), join(f".{f.name}"))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v, join(f"[{k!r}]")) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, join(f"[{i}]"))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any) -> None:
    """Save a tree of tensors as the JAX package's flat npz checkpoint (a
    path without ".npz" writes path + ".npz", the JAX package's form where
    orbax is missing; this package writes no orbax directory)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _map(lambda k, v: flat.__setitem__(k, _host(v)), tree)
    np.savez_compressed(path, **flat)


def restore(path: str, like: Any) -> Any:
    """A tree with the structure of `like` from a flat npz checkpoint
    (either package's), each tensor on the device of like's leaf with the
    file's dtype. An orbax directory (what the JAX package writes for a
    path without ".npz" when orbax is installed) raises: this package does
    not read orbax."""
    f = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(f):
        if os.path.isdir(path):
            raise ValueError(
                f"{path!r} is an orbax checkpoint directory; this package "
                "reads flat npz checkpoints only (save with a .npz path)")
        raise FileNotFoundError(f)
    with np.load(f) as data:
        def leaf(key, old):
            arr = np.array(data[key])
            if isinstance(old, torch.Tensor):
                return torch.from_numpy(arr).to(old.device)
            return arr

        return _map(leaf, like)
