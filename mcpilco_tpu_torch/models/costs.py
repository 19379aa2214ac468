"""Cost functions over particle trajectories.

A cost is a static config object with
``stage_costs(states [T,P,ds], inputs [T,P,du], trial_index) -> [T,P]``;
:func:`expected_cost` reduces it to (sum_t mean_particles(c_t),
sum_t std_particles(c_t)), as ``mcpilco_tpu/models/costs.py`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .kernels import _as_tuple


def expected_cost(stage: torch.Tensor):
    """Reduce [T, P] stage costs to (sum of means, sum of stds); [T, L, P]
    stage costs of L lanes reduce per lane, to two [L] tensors.

    The particle std is the unbiased estimator (ddof=1) and is detached from
    the gradient, as in the reference.
    """
    mean_t = torch.mean(stage, dim=-1)
    std_t = torch.std(stage, dim=-1, correction=1)
    return torch.sum(mean_t, dim=0), torch.sum(std_t.detach(), dim=0)


class CostBase:
    def stage_costs(self, states, inputs, trial_index=0):
        raise NotImplementedError

    def __call__(self, states, inputs, trial_index=0):
        return expected_cost(self.stage_costs(states, inputs, trial_index))


@dataclasses.dataclass(frozen=True)
class QuadraticDistance(CostBase):
    """Squared lengthscale-weighted distance to a target state over
    ``active_dims``; ``abs_dims`` are taken |.| of first, which makes +target
    and -target equivalent for angle dims."""

    target_state: Tuple[float, ...]
    lengthscales: Tuple[float, ...]
    active_dims: Optional[Tuple[int, ...]] = None
    abs_dims: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(
            self, "target_state", tuple(float(v) for v in np.asarray(self.target_state, float))
        )
        object.__setattr__(
            self, "lengthscales",
            tuple(float(v) for v in np.asarray(self.lengthscales, float).reshape(-1)),
        )
        object.__setattr__(self, "active_dims", _as_tuple(self.active_dims))
        object.__setattr__(self, "abs_dims", _as_tuple(self.abs_dims))

    def _dist(self, states):
        if self.abs_dims is not None:
            ab = torch.zeros(states.shape[-1], dtype=torch.bool, device=states.device)
            ab[list(self.abs_dims)] = True
            states = torch.where(ab, torch.abs(states), states)
        if self.active_dims is not None:
            states = states[..., list(self.active_dims)]
        ls = torch.as_tensor(self.lengthscales, dtype=states.dtype, device=states.device)
        tgt = torch.as_tensor(self.target_state, dtype=states.dtype, device=states.device)
        d = (states - tgt) / ls
        return torch.sum(d * d, dim=-1)

    def stage_costs(self, states, inputs, trial_index=0):
        return self._dist(states)


@dataclasses.dataclass(frozen=True)
class SaturatedDistance(QuadraticDistance):
    """1 - exp(-squared weighted distance)."""

    def stage_costs(self, states, inputs, trial_index=0):
        return 1.0 - torch.exp(-self._dist(states))


@dataclasses.dataclass(frozen=True)
class CartPoleCost(CostBase):
    """1 - exp(-((|theta|-theta*)/l_th)^2 - ((x-x*)/l_x)^2),
    target_state = (theta*, x*).  ``lengthscales`` may be per-trial
    ([n_trials, 2] with ``per_trial=True``)."""

    target_state: Tuple[float, float]
    lengthscales: Tuple
    angle_index: int = 2
    pos_index: int = 0
    per_trial: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "target_state", tuple(float(v) for v in np.asarray(self.target_state, float))
        )
        ls = np.asarray(self.lengthscales, float)
        object.__setattr__(
            self,
            "lengthscales",
            tuple(tuple(float(x) for x in row) for row in ls)
            if ls.ndim == 2
            else tuple(float(x) for x in ls.reshape(-1)),
        )

    def stage_costs(self, states, inputs, trial_index=0):
        theta = states[..., self.angle_index]
        x = states[..., self.pos_index]
        t_th, t_x = self.target_state
        ls = self.lengthscales
        if self.per_trial:
            # a JAX gather clamps an index past the schedule to its last row
            n = len(ls)
            i = int(trial_index)
            ls = ls[min(max(i + n if i < 0 else i, 0), n - 1)]
        l_th, l_x = ls[0], ls[1]
        return 1.0 - torch.exp(-(((torch.abs(theta) - t_th) / l_th) ** 2) - ((x - t_x) / l_x) ** 2)
