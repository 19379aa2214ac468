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
from typing import Tuple

import numpy as np
import torch

from ..ops import linalg
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


def select(gp: MultiGP, config: SODConfig, params: GPParams, x: torch.Tensor,
           y: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Per-head SOD selection masks [G, N] over the shared dataset, visiting
    candidates in index order (sample 0 seeds every subset).

    ``x``: [N, D] padded inputs; ``y``: [G, N]; ``valid_mask``: [N]; each with
    the lane axes in front for lanes, which are selected by one batched
    loop.
    """
    if config.permutation:
        raise NotImplementedError("SOD with a random candidate order is not ported yet")
    n = x.shape[-2]
    heads = params.log_sigma_n.shape  # [*L, G]
    kp = params.kernel
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    noise = torch.exp(2.0 * params.log_sigma_n)  # [*L, G]
    thr = config.thresholds(gp, params)
    hx = MultiGP._hx(x)
    Kx = gp.kernel.gram(kp, hx, hx)  # [*L, G, N, N], hoisted out of the loop
    prior = gp.kernel.diag(kp, hx).expand(*heads, n)  # [*L, G, N]
    sel = torch.zeros((*heads, n), dtype=x.dtype, device=x.device)
    sel[..., 0] = valid_mask[..., None, 0]
    for idx in range(1, n):
        jit = linalg.adaptive_jitter(Kx, sel, rel=gp.jitter, floor=gp.jitter)
        L = linalg.masked_cholesky(Kx + (noise + jit)[..., None, None] * eye, sel)
        k_vec = Kx[..., idx] * sel  # k(x_sel, x_idx)
        w = linalg.chol_solve(L, k_vec[..., None])[..., 0] * sel
        var = prior[..., idx] - torch.sum(k_vec * w, dim=-1)
        keep = (torch.sqrt(torch.clamp(var, min=0.0)) > thr) & (valid_mask[..., None, idx] > 0)
        sel[..., idx] = torch.where(keep, torch.ones_like(var), sel[..., idx])
    return sel
