"""Cost functions over particle trajectories.

A cost is a static config object with
``stage_costs(states [T,P,ds], inputs [T,P,du], trial_index) -> [T,P]``;
:func:`expected_cost` reduces it to (sum_t mean_particles(c_t),
sum_t std_particles(c_t)), as ``mcpilco_tpu/models/costs.py`` does, over
particle shards on several ranks too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import consts
from .kernels import _as_tuple


def expected_cost(stage: torch.Tensor, group=None):
    """Reduce [T, P] stage costs to (sum of means, sum of stds); [T, L, P]
    stage costs of L lanes reduce per lane, to two [L] tensors.

    The particle std is the unbiased estimator (ddof=1), in two passes (the
    squared deviations from the mean), and is detached from the gradient,
    as in the reference.

    ``group``: a process group whose ranks hold the other particle shards
    (P is then their total).  The sums over particles are all-reduced, so
    every rank holds the same bits of the mean, while its gradient reaches
    this rank's particles only (the ranks sum the gradients); the deviations
    are taken from that global mean.  A group of one rank gives the bits of
    ``group=None``.
    """
    local = torch.sum(stage, dim=-1)  # [T, *L]
    P = stage.shape[-1] * (1 if group is None else dist.get_world_size(group))
    if group is None:
        mean_t = total_mean = local / P
    else:
        total = local.detach().clone()
        dist.all_reduce(total, group=group)
        total_mean = total / P
        # the value is total_mean's exactly (the added term is 0), the
        # gradient local's
        mean_t = total_mean + (local - local.detach()) / P
    dev = stage.detach() - total_mean.detach()[..., None]
    sq = torch.sum(dev * dev, dim=-1)
    if group is not None:
        dist.all_reduce(sq, group=group)
    std_t = torch.sqrt(sq / (P - 1))
    return torch.sum(mean_t, dim=0), torch.sum(std_t, dim=0)


class CostBase:
    def stage_costs(self, states, inputs, trial_index=0):
        raise NotImplementedError

    def __call__(self, states, inputs, trial_index=0, group=None):
        """(expected cost, particle std) of a rollout; ``group``: see
        :func:`expected_cost`."""
        return expected_cost(self.stage_costs(states, inputs, trial_index), group)


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
            ab = tuple(i in self.abs_dims for i in range(states.shape[-1]))
            states = torch.where(consts.tensor(ab, torch.bool, states.device), torch.abs(states),
                                 states)
        if self.active_dims is not None:
            states = states[..., consts.index(self.active_dims, states.device)]
        ls = consts.tensor(self.lengthscales, states.dtype, states.device)
        tgt = consts.tensor(self.target_state, states.dtype, states.device)
        d = (states - tgt) / ls
        return torch.sum(d * d, dim=-1)

    def stage_costs(self, states, inputs, trial_index=0):
        return self._dist(states)


@dataclasses.dataclass(frozen=True)
class SaturatedDistance(QuadraticDistance):
    """1 - exp(-squared weighted distance)."""

    def stage_costs(self, states, inputs, trial_index=0):
        return 1.0 - torch.exp(-self._dist(states))


def _schedule_row(rows, trial_index):
    """Row ``trial_index`` of a per-trial schedule, clamped into it as a JAX
    gather clamps an index past the schedule."""
    n = len(rows)
    i = int(trial_index)
    return rows[min(max(i + n if i < 0 else i, 0), n - 1)]


def _static_lengthscales(ls):
    """Lengthscales as native floats: a tuple, or a tuple of per-trial rows."""
    ls = np.asarray(ls, float)
    return (tuple(tuple(float(x) for x in row) for row in ls) if ls.ndim == 2
            else tuple(float(x) for x in ls.reshape(-1)))


@dataclasses.dataclass(frozen=True)
class SaturatedTrajectoryTracking(CostBase):
    """1 - exp(-||(s_t - target_t) / l||^2) against a time-indexed target
    trajectory.  ``lengthscales`` may be per-trial ([n_trials, d] with
    ``per_trial=True``); ``used_indices`` selects the tracked state dims."""

    target_traj: Tuple[Tuple[float, ...], ...]
    lengthscales: Tuple
    per_trial: bool = False
    used_indices: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        tt = tuple(tuple(float(v) for v in row) for row in np.asarray(self.target_traj))
        object.__setattr__(self, "target_traj", tt)
        object.__setattr__(self, "lengthscales", _static_lengthscales(self.lengthscales))
        object.__setattr__(self, "used_indices", _as_tuple(self.used_indices))

    def stage_costs(self, states, inputs, trial_index=0):
        T, n = states.shape[0], len(self.target_traj)
        # the time index clamped into the target: an executed trial carries
        # T+1 states against a T-step target, and its last sample is scored
        # against the final target state
        rows = tuple(self.target_traj[min(t, n - 1)] for t in range(T))
        traj = consts.tensor(rows, states.dtype, states.device)  # [T, ds]
        ls = self.lengthscales
        if self.per_trial:
            ls = _schedule_row(ls, trial_index)
        ls = consts.tensor(ls, states.dtype, states.device)
        err = states - traj.reshape((T,) + (1,) * (states.dim() - 2) + (traj.shape[-1],))
        if self.used_indices is not None:
            idx = consts.index(self.used_indices, states.device)
            err = err[..., idx]
            ls = ls[..., idx] if ls.dim() else ls
        d = torch.sum((err / ls) ** 2, dim=-1)
        return 1.0 - torch.exp(-d)


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
        object.__setattr__(self, "lengthscales", _static_lengthscales(self.lengthscales))

    def stage_costs(self, states, inputs, trial_index=0):
        theta = states[..., self.angle_index]
        x = states[..., self.pos_index]
        t_th, t_x = self.target_state
        ls = self.lengthscales
        if self.per_trial:
            ls = _schedule_row(ls, trial_index)
        l_th, l_x = ls[0], ls[1]
        return 1.0 - torch.exp(-(((torch.abs(theta) - t_th) / l_th) ** 2) - ((x - t_x) / l_x) ** 2)
