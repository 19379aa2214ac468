"""Differentiable Monte-Carlo particle rollouts through the learned GP model.

One rollout is a Python loop over the horizon (``mcpilco_tpu/control/rollout.py``
runs it as a ``lax.scan``) whose step does, for all particles at once:

    gp_in = model.gp_inputs(s, u)
    mu, var = gp.predict(params, post, gp_in)      # fused kernels on the card
    s' = model.next_state(s, u, mu + sqrt(var) * eps)
    u' = policy(theta, s', t)

Everything is differentiable w.r.t. the policy parameters (BPTT through the
loop).  The rollout's random numbers are drawn up front, one tensor per
stream, from generators seeded by the rollout key (:class:`RolloutNoise`);
tests hand in their own draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.dynamics import DynamicsModel
from ..models.gp import MultiGP, Posterior
from ..models.policies import PolicyBase
from ..utils import prng


@dataclasses.dataclass(frozen=True)
class InitialStateDistribution:
    """Initial particle distribution; only kind='gaussian' (mean/var) is
    ported so far."""

    kind: str
    mean: Tuple = ()
    var: Tuple = ()

    def __post_init__(self):
        if self.kind != "gaussian":
            raise NotImplementedError(f"initial distribution kind {self.kind!r} is not ported yet")
        for f in ("mean", "var"):
            v = np.asarray(getattr(self, f), float)
            object.__setattr__(self, f, tuple(float(x) for x in v.reshape(-1)))

    def sample(self, key, num_particles: int, device, dtype=torch.float32,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[num_particles, ds] draws; ``eps`` replaces the standard-normal draw."""
        mean = torch.as_tensor(self.mean, dtype=dtype, device=device)
        std = torch.sqrt(torch.as_tensor(self.var, dtype=dtype, device=device))
        if eps is None:
            eps = torch.randn((num_particles, mean.shape[0]), dtype=dtype, device=device,
                              generator=prng.generator(key, device))
        return mean + std * eps

    def sample_single(self, key, device="cpu", dtype=torch.float32) -> torch.Tensor:
        """One initial state for a real-system interaction."""
        return self.sample(key, 1, device, dtype)[0]


class RolloutResult(NamedTuple):
    states: torch.Tensor  # [T, P, ds]
    inputs: torch.Tensor  # [T, P, du]


class RolloutNoise(NamedTuple):
    """The random numbers of one rollout.

    state: [T-1, P, G] standard normals of the next-state draws;
    keep:  [T, P, num_basis] dropout keep-masks of the policy, or None;
    init:  [P, ds] standard normals of the initial particles, or None
           (read by the policy optimizer, not by ``simulate``).
    """

    state: torch.Tensor
    keep: Optional[torch.Tensor] = None
    init: Optional[torch.Tensor] = None


class _ClipBPTT(torch.autograd.Function):
    """Identity whose backward clips the per-particle cotangent norm at
    ``cap`` (the chaotic-BPTT stabilizer of the JAX package)."""

    @staticmethod
    def forward(ctx, x, cap):
        ctx.cap = cap
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        return g * torch.clamp(ctx.cap / (n + 1e-30), max=1.0), None


def _clip_bptt(x, cap):
    return _ClipBPTT.apply(x, cap)


@dataclasses.dataclass(frozen=True)
class RolloutEngine:
    """Binds (dynamics model, GP, policy) into particle rollouts."""

    model: DynamicsModel
    gp: MultiGP
    policy: PolicyBase
    # per-particle state-cotangent norm cap applied once per step; None disables
    bptt_clip: Optional[float] = None

    def draw_noise(self, key, num_particles: int, horizon: int, p_dropout: float, device,
                   dtype=torch.float32) -> RolloutNoise:
        """All random numbers of one rollout, one draw per stream."""
        state = torch.randn((horizon - 1, num_particles, self.gp.num_heads), dtype=dtype,
                            device=device,
                            generator=prng.generator(prng.stream(key, prng.STREAM_ROLLOUT), device))
        keep = None
        if p_dropout > 0:
            keep = self.policy.dropout_keep(
                prng.stream(key, prng.STREAM_DROPOUT),
                (horizon, num_particles, self.policy.num_basis), p_dropout, device,
            )
        return RolloutNoise(state=state, keep=keep)

    def simulate(self, key, policy_params, gp_params, posterior: Posterior, s0: torch.Tensor,
                 horizon: int, p_dropout=0.0, particle_pred: bool = True,
                 noise: Optional[RolloutNoise] = None) -> RolloutResult:
        """Roll ``s0`` [P, ds] forward ``horizon`` steps (step 0 = s0)."""
        if noise is None:
            noise = self.draw_noise(key, s0.shape[0], horizon, p_dropout, s0.device, s0.dtype)

        def policy_at(s, t):
            keep = None if noise.keep is None else noise.keep[t]
            return self.policy.apply(policy_params, s, t, p_dropout=p_dropout, keep=keep)

        s, u = s0, policy_at(s0, 0)
        states, inputs = [s0], [u]
        for t in range(1, horizon):
            if self.bptt_clip is not None:
                s = _clip_bptt(s, self.bptt_clip)
            gp_in = self.model.gp_inputs(s, u)
            mean, var = self.gp.predict(gp_params, posterior, gp_in)
            s, _, _ = self.model.sample_next_state(
                s, u, mean, var, particle_pred=particle_pred, eps=noise.state[t - 1]
            )
            u = policy_at(s, t)
            states.append(s)
            inputs.append(u)
        return RolloutResult(states=torch.stack(states), inputs=torch.stack(inputs))

    def replay(self, gp_params, posterior: Posterior, s0: torch.Tensor,
               inputs: torch.Tensor) -> torch.Tensor:
        """Mean open-loop rollout following a recorded input trajectory (the
        rollout-MSE diagnostic).  ``s0``: [ds]; ``inputs``: [T, du] -> [T, ds]."""
        s = s0[None, :]
        traj = [s0]
        for t in range(1, inputs.shape[0]):
            u = inputs[t - 1][None, :]
            mean, var = self.gp.predict(gp_params, posterior, self.model.gp_inputs(s, u))
            s, _, _ = self.model.sample_next_state(s, u, mean, var, particle_pred=False)
            traj.append(s[0])
        return torch.stack(traj)
