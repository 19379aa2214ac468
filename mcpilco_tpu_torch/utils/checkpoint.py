"""Checkpoints without pickle, in the layout of ``mcpilco_tpu/utils/checkpoint.py``.

A checkpoint is a directory:

    <dir>/manifest.json          {"meta": {...}, "trees": {name: structure}}
    <dir>/<name>.npz             the leaves of tree <name>: leaf_0 ... leaf_{n-1}

Leaves are written in the order ``jax.tree_util.tree_flatten`` gives them:
dict values by sorted key, NamedTuple fields and tuple or list items in
order; ``None`` holds no leaf.  So a directory written by either package
loads in the other.  The ``trees`` strings name the leaves in order, for a
reader; loading takes the structure from a template, as JAX's ``load``
does.  This module imports no jax.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in JAX's flatten order; a path holds dict keys,
    NamedTuple field names and sequence positions."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from flatten_with_path(v, path + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, path + (i,))
    else:
        yield path, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _unflatten(template, leaves: Iterator[np.ndarray], device):
    """``template``'s containers around the next leaves: a tensor leaf of the
    template becomes a tensor on ``device`` (its own device when None), any
    other leaf a numpy array."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, device) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves, device) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves, device) for v in template)
    leaf = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(leaf, device=template.device if device is None else device)
    return leaf


def save(path: str, trees: Dict[str, Any], meta: Dict[str, Any] | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    manifest = {"meta": meta or {}, "trees": {}}
    for name, tree in trees.items():
        pairs = list(flatten_with_path(tree))
        np.savez(os.path.join(path, f"{name}.npz"),
                 **{f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(pairs)})
        manifest["trees"][name] = "leaves: " + ", ".join(
            "/".join(map(str, p)) or "." for p, _ in pairs)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, default=str)


def load(path: str, templates: Dict[str, Any], device=None) -> Tuple[Dict[str, Any], dict]:
    """Load named trees using ``templates`` (same-structure examples) for the
    structure; a tensor leaf of a template loads on ``device``.  Returns
    (trees, meta)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, template in templates.items():
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
        want = sum(1 for _ in flatten_with_path(template))
        if len(leaves) != want:
            raise ValueError(f"{path}/{name}.npz holds {len(leaves)} leaves, the template {want}")
        out[name] = _unflatten(template, iter(leaves), device)
    return out, manifest["meta"]


def peek_meta(path: str) -> Dict[str, Any]:
    """Read only a checkpoint's scalar metadata (no npz loads): auto-resume
    checks the stored scenario config against the current one with it before
    restoring any array."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["meta"]


def save_meta(path: str, meta: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
