"""Subset-of-Data (SOD) greedy inducing-point selection, on the device.

Keep candidate i if the posterior std at x_i, given the points kept so far,
exceeds a threshold (``mcpilco_tpu/models/sod.py``).  The loop is
sequential: N-1 masked Choleskys, each batched over the heads, with the
selection mask updated on the device (no host sync per candidate).

Threshold modes:
- 'relative': threshold = value * sigma_n (per head)
- 'absolute': threshold = value[head]
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import linalg
from ..utils import prng
from .gp import GPParams, MultiGP


@dataclasses.dataclass(frozen=True)
class SODConfig:
    threshold_mode: str = "relative"  # 'relative' | 'absolute'
    threshold: Tuple[float, ...] = (0.5,)
    permutation: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "threshold", tuple(float(v) for v in np.asarray(self.threshold).reshape(-1))
        )

    def thresholds(self, gp: MultiGP, params: GPParams) -> torch.Tensor:
        sigma_n = torch.exp(params.log_sigma_n)
        t = torch.as_tensor(self.threshold, dtype=sigma_n.dtype, device=sigma_n.device)
        if self.threshold_mode == "relative":
            return t[0] * sigma_n  # [G]
        return t * torch.ones(gp.num_heads, dtype=sigma_n.dtype, device=sigma_n.device)


@dataclasses.dataclass(frozen=True)
class SORConfig(SODConfig):
    """SOD selection options plus the SOR refinement stage: after the exact
    MLL fit and the greedy inducing selection, optionally re-train the
    hyperparameters (and, with ``train_inducing``, the inducing inputs)
    against the SOR MLL for ``refine_epochs`` (``MultiGP.fit_sor``)."""

    refine_epochs: int = 0
    refine_lr: float = 0.01
    train_inducing: bool = False


def random_order(n: int, key) -> torch.Tensor:
    """The candidate order of ``SODConfig(permutation=True)``: index 0 first
    (sample 0 seeds every subset), then a permutation of 1..n-1 drawn from
    the key's own generator on the CPU, so that the card and the CPU visit
    the same order.  ``key`` is one key, or a list of keys (one per lane)
    for an order [L, n]."""
    if isinstance(key, list):
        return torch.stack([random_order(n, k) for k in key])
    perm = torch.randperm(n - 1, generator=prng.generator(key, "cpu")) + 1
    return torch.cat([torch.zeros(1, dtype=perm.dtype), perm])


def select(gp: MultiGP, config: SODConfig, params: GPParams, x: torch.Tensor,
           y: torch.Tensor, valid_mask: torch.Tensor, key=None,
           order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-head SOD selection masks [G, N] over the shared dataset.

    ``x``: [N, D] padded inputs; ``y``: [G, N]; ``valid_mask``: [N]; each with
    the lane axes in front for lanes, which are selected by one batched
    loop.  Candidates are visited in index order, or with
    ``config.permutation`` in :func:`random_order` of ``key`` (a list of
    keys with lanes, each lane its own order).  ``order`` [N] (or [*L, N])
    gives the visiting order explicitly, as a test hands in the JAX
    package's permutation.
    """
    n = x.shape[-2]
    if order is None:
        order = random_order(n, key) if config.permutation else torch.arange(n)
    heads = params.log_sigma_n.shape  # [*L, G]
    lanes = heads[:-1]
    order = order.to(x.device).expand(*lanes, n)
    kp = params.kernel
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    noise = torch.exp(2.0 * params.log_sigma_n)  # [*L, G]
    thr = config.thresholds(gp, params)
    hx = MultiGP._hx(x)
    Kx = gp.kernel.gram(kp, hx, hx)  # [*L, G, N, N], hoisted out of the loop
    prior = gp.kernel.diag(kp, hx).expand(*heads, n)  # [*L, G, N]

    def at(t, idx):
        """``t`` [*L, ..., N] at each lane's index ``idx`` [*L]: [*L, ...]."""
        i = idx.reshape(*lanes, *(1,) * (t.dim() - len(lanes)))
        return torch.take_along_dim(t, i, dim=-1)[..., 0]

    def set_at(t, idx, v):
        i = idx.reshape(*lanes, 1, 1).expand(*heads, 1)
        return t.scatter(-1, i, v[..., None])

    sel = torch.zeros((*heads, n), dtype=x.dtype, device=x.device)
    first = order[..., 0]
    sel = set_at(sel, first, at(valid_mask, first)[..., None].expand(heads))
    for t in range(1, n):
        idx = order[..., t]
        jit = linalg.adaptive_jitter(Kx, sel, rel=gp.jitter, floor=gp.jitter)
        L = linalg.masked_cholesky(Kx + (noise + jit)[..., None, None] * eye, sel)
        k_vec = at(Kx, idx) * sel  # k(x_sel, x_idx)
        w = linalg.chol_solve(L, k_vec[..., None])[..., 0] * sel
        var = at(prior, idx) - torch.sum(k_vec * w, dim=-1)
        keep = (torch.sqrt(torch.clamp(var, min=0.0)) > thr) & (at(valid_mask, idx)[..., None] > 0)
        sel = set_at(sel, idx, torch.where(keep, torch.ones_like(var), at(sel, idx)))
    return sel
