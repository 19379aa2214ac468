"""Carry a tree of numpy arrays into the port's tensors.

The tree is what ``jax.tree_util.tree_map(np.asarray, tree)`` makes of a JAX
``GPParams``, ``Posterior`` or policy-params dict: dicts, tuples, lists and
NamedTuples of arrays.  With it, the tests feed both packages the same
numbers.  This module imports no jax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_torch(tree, device, dtype: Optional[torch.dtype] = None, into=None):
    """Convert every array leaf of ``tree`` to a tensor on ``device``.

    Leaves keep their numpy dtype unless ``dtype`` is given.  Containers keep
    their type; ``into`` names a NamedTuple class (the port's ``GPParams`` or
    ``Posterior``) that the top-level NamedTuple is rebuilt as, by field.
    """
    if into is not None:
        fields = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
        return into(**{k: to_torch(v, device, dtype) for k, v in fields.items()})
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v, device, dtype) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    return torch.tensor(np.asarray(tree), device=device, dtype=dtype)
