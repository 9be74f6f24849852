"""Flat npz checkpoints keyed by flax tree paths (the format the JAX
package's utils/checkpoint.save writes for ``*.npz``): each key is the
tree path with every part in brackets, e.g.
``['params']/['ConvBN_0']/['Conv_0']/['kernel']``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

import numpy as np

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
