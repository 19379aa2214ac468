"""Tensors of configuration constants, made once per device and dtype.

Config objects hold their constants as Python tuples.  Turning them into a
tensor where they are used (``torch.tensor``, ``torch.as_tensor``, indexing
with a list of ints) copies from the host on every call: one copy per
rollout step, and an operation that a CUDA graph cannot capture.
:func:`tensor` and :func:`index` make each such tensor once per
(values, dtype, device) and hand the same tensor to every later caller,
which must not write to it.
"""

from __future__ import annotations

import torch

_made = {}


def tensor(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once;
    ``values`` a number or a (nested) tuple of numbers."""
    key = (values, dtype, torch.device(device))
    t = _made.get(key)
    if t is None:
        t = _made[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def index(dims, device) -> torch.Tensor:
    """The int64 index tensor of ``dims`` (a sequence of ints) on ``device``."""
    return tensor(tuple(int(i) for i in dims), torch.long, device)
