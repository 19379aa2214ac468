"""One-step GP dynamics models: state/input <-> GP-IO mappings + integration.

Each model family is a static config with pure functions on tensors, used to
build training sets and inside the rollout (``mcpilco_tpu/models/dynamics.py``):

- ``gp_inputs(states, inputs) -> [.., D_gp]`` feature map
- ``gp_targets(states) -> [G, N-1]`` per-head regression targets
- ``next_state(state, input, delta) -> state'``

Families: :class:`DeltaState` (one head per state dim), :class:`DeltaStateAngles`
(the same with sin/cos-extended inputs), :class:`SpeedIntegration` (heads
predict velocity deltas, positions integrate by trapezoid) and
:class:`FurutaSemiparametric` (speed integration with the Furuta pendulum's
physics features appended to the GP input).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils import consts
from .kernels import _as_tuple


class DynamicsModel:
    """Static config base; see module docstring."""

    state_dim: int
    input_dim: int

    @property
    def num_heads(self) -> int:
        raise NotImplementedError

    @property
    def gp_input_dim(self) -> int:
        raise NotImplementedError

    def gp_inputs(self, states: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
        return torch.cat([states, inputs], dim=-1)

    def gp_targets(self, states: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def next_state(self, state, inp, delta) -> torch.Tensor:
        raise NotImplementedError

    def training_pairs(self, states: torch.Tensor, inputs: torch.Tensor):
        """(gp_inputs [N-1, D_gp], targets [G, N-1]) from one trajectory."""
        return self.gp_inputs(states, inputs)[:-1], self.gp_targets(states)

    def sample_next_state(self, state, inp, mean, var, generator=None, particle_pred=True,
                          eps: Optional[torch.Tensor] = None):
        """Reparameterized next-state draw.

        ``mean``/``var`` are [G, P] head outputs of ``MultiGP.predict`` ([L, G,
        P] for lanes).  The standard-normal draw ``eps`` [P, G] is taken from
        ``generator`` unless given.  Returns (next state, mean [P, G],
        variance [P, G]).
        """
        mu = torch.movedim(mean, -2, -1)
        # the floor keeps d(sqrt)/d(var) finite where the clamped posterior
        # variance is exactly zero
        sd = torch.sqrt(torch.movedim(var, -2, -1) + 1e-12)
        if particle_pred:
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                                  device=mu.device)
            delta = mu + sd * eps
        else:
            delta = mu
        return self.next_state(state, inp, delta), mu, sd * sd


def _angle_extend(states, angle_idx, not_angle_idx):
    """[x_other, sin(x_ang), cos(x_ang)]."""
    ang = states[..., consts.index(angle_idx, states.device)]
    rest = states[..., consts.index(not_angle_idx, states.device)]
    return torch.cat([rest, torch.sin(ang), torch.cos(ang)], dim=-1)


@dataclasses.dataclass(frozen=True)
class DeltaState(DynamicsModel):
    """One GP head per state dim predicting s_{t+1} - s_t."""

    state_dim: int
    input_dim: int

    @property
    def num_heads(self) -> int:
        return self.state_dim

    @property
    def gp_input_dim(self) -> int:
        return self.state_dim + self.input_dim

    def gp_targets(self, states):
        return (states[1:] - states[:-1]).T

    def next_state(self, state, inp, delta):
        return state + delta


@dataclasses.dataclass(frozen=True)
class DeltaStateAngles(DeltaState):
    """Delta-state model with sin/cos-extended GP inputs."""

    angle_indices: Tuple[int, ...] = ()
    not_angle_indices: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "angle_indices", _as_tuple(self.angle_indices) or ())
        object.__setattr__(self, "not_angle_indices", _as_tuple(self.not_angle_indices) or ())

    @property
    def gp_input_dim(self) -> int:
        return len(self.not_angle_indices) + 2 * len(self.angle_indices) + self.input_dim

    def gp_inputs(self, states, inputs):
        ext = _angle_extend(states, self.angle_indices, self.not_angle_indices)
        return torch.cat([ext, inputs], dim=-1)


@dataclasses.dataclass(frozen=True)
class SpeedIntegration(DynamicsModel):
    """Speed-integration model: ``len(vel_indices)`` GPs predict velocity
    deltas dv; the next state is v' = v + dv, p' = p + Ts v + Ts/2 dv, where
    position ``pos_indices[i]`` integrates velocity ``vel_indices[i]``."""

    state_dim: int
    input_dim: int
    dt: float
    vel_indices: Tuple[int, ...]
    pos_indices: Tuple[int, ...]
    angle_indices: Tuple[int, ...] = ()
    not_angle_indices: Tuple[int, ...] = ()

    def __post_init__(self):
        for f in ("vel_indices", "pos_indices", "angle_indices", "not_angle_indices"):
            object.__setattr__(self, f, _as_tuple(getattr(self, f)) or ())

    @property
    def num_heads(self) -> int:
        return len(self.vel_indices)

    @property
    def gp_input_dim(self) -> int:
        n_ext = (
            len(self.not_angle_indices) + 2 * len(self.angle_indices)
            if (self.angle_indices or self.not_angle_indices)
            else self.state_dim
        )
        return n_ext + self.input_dim

    def gp_inputs(self, states, inputs):
        if self.angle_indices or self.not_angle_indices:
            ext = _angle_extend(states, self.angle_indices, self.not_angle_indices)
        else:
            ext = states
        return torch.cat([ext, inputs], dim=-1)

    def gp_targets(self, states):
        vel = states[..., consts.index(self.vel_indices, states.device)]
        return (vel[1:] - vel[:-1]).T

    def next_state(self, state, inp, delta):
        vel, pos = (consts.index(i, state.device) for i in (self.vel_indices, self.pos_indices))
        # on [rows, ds]: with a leading axis of size 1 (one lane) the indexing
        # backward would add two reductions per rollout step
        shape = state.shape
        state, delta = state.reshape(-1, shape[-1]), delta.reshape(-1, delta.shape[-1])
        v = state[:, vel]
        nxt = state.clone()
        nxt[:, vel] = v + delta
        nxt[:, pos] = state[:, pos] + self.dt * v + 0.5 * self.dt * delta
        return nxt.reshape(shape)


@dataclasses.dataclass(frozen=True)
class FurutaSemiparametric(SpeedIntegration):
    """Furuta-pendulum semiparametric model: state [theta_h, theta_v,
    dtheta_h, dtheta_v]; the GP input is [state, input] followed by the seven
    physics-derived features of the forward dynamics, meant to pair with a
    Sum(SEArd, Linear) kernel."""

    @property
    def gp_input_dim(self) -> int:
        return self.state_dim + self.input_dim + 7

    def gp_inputs(self, states, inputs):
        th_v, dth_h, dth_v = states[..., 1:2], states[..., 2:3], states[..., 3:4]
        sin_v, sin_2v = torch.sin(th_v), torch.sin(2.0 * th_v)
        return torch.cat([
            states,
            inputs,
            sin_v * dth_v**2,
            dth_h * dth_v * sin_2v,
            dth_h,
            dth_h**2 * sin_2v,
            dth_v,
            sin_v,
            inputs * torch.cos(th_v),
        ], dim=-1)
