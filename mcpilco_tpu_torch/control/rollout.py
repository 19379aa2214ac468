"""Differentiable Monte-Carlo particle rollouts through the learned GP model.

One rollout is a Python loop over the horizon (``mcpilco_tpu/control/rollout.py``
runs it as a ``lax.scan``) whose step does, for all particles at once:

    gp_in = model.gp_inputs(s, u)
    mu, var = gp.predict(params, post, gp_in)      # fused kernels on the card
    s' = model.next_state(s, u, mu + sqrt(var) * eps)
    u' = policy(theta, s', t)

With :class:`PMSSensors` (4PMS), the policy sees ``sensor(s')`` instead:
noisy positions and online-filtered finite-difference velocities.
Everything is differentiable w.r.t. the policy parameters (BPTT through the
loop).  The rollout's random numbers are drawn up front, one tensor per
stream, from generators seeded by the rollout key (:class:`RolloutNoise`);
tests hand in their own draws instead.

With ``remat``, each step runs under ``torch.utils.checkpoint``: its
activations are recomputed in the backward pass instead of kept, which
bounds the memory of long horizons (UR5: 200 steps) at one extra forward
per step.

Lanes: with policy parameters [L, ...] and particles [L, P, ds], one
rollout runs L independent optimizations at once (restart lanes, which
share one posterior, or the seed farm's seeds, each with its own); the key
is then a list of L keys, and each lane draws from its own generators
exactly what a rollout of that lane alone would draw.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import filters
from ..models.dynamics import DynamicsModel
from ..models.gp import MultiGP, Posterior
from ..models.policies import PolicyBase
from ..utils import consts, prng


@dataclasses.dataclass(frozen=True)
class InitialStateDistribution:
    """Initial particle distribution.

    kind: 'gaussian' (mean/var), 'uniform' (low/high), or 'multi_gauss'
    (rows of mean/var are mixture components, picked uniformly).
    """

    kind: str
    mean: Tuple = ()
    var: Tuple = ()
    low: Tuple = ()
    high: Tuple = ()

    def __post_init__(self):
        if self.kind not in ("gaussian", "uniform", "multi_gauss"):
            raise ValueError(f"unknown initial distribution kind: {self.kind}")
        for f in ("mean", "var", "low", "high"):
            v = np.asarray(getattr(self, f), float)
            object.__setattr__(
                self, f,
                tuple(tuple(float(x) for x in row) for row in v) if v.ndim == 2
                else tuple(float(x) for x in v.reshape(-1)),
            )

    def draw(self, key, num_particles: int, device, dtype=torch.float32):
        """The random numbers of one :meth:`sample` from ``key``: (eps
        [num_particles, ds], the base draw: uniform on [0, 1) for 'uniform',
        standard normal otherwise; idx [num_particles], the component draw of
        'multi_gauss', else None)."""
        gen = prng.generator(key, device)
        idx = None
        if self.kind == "multi_gauss":
            idx = torch.randint(0, len(self.mean), (num_particles,), generator=gen, device=device)
        if self.kind == "uniform":
            return torch.rand((num_particles, len(self.low)), generator=gen, dtype=dtype,
                              device=device), None
        return torch.randn((num_particles, np.shape(self.mean)[-1]), generator=gen, dtype=dtype,
                           device=device), idx

    def sample(self, key, num_particles: int, device, dtype=torch.float32,
               eps: Optional[torch.Tensor] = None,
               idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[num_particles, ds] draws.  ``eps`` [num_particles, ds] replaces the
        base draw of :meth:`draw`; ``idx`` [num_particles] replaces the
        component draw of 'multi_gauss'.  Lanes: ``eps`` [L, P, ds] and
        ``idx`` [L, P] give [L, P, ds]."""
        if eps is None or (self.kind == "multi_gauss" and idx is None):
            drawn = self.draw(key, num_particles, device, dtype)
            eps = drawn[0] if eps is None else eps
            idx = drawn[1] if idx is None else idx
        if self.kind == "uniform":
            lo, hi = (consts.tensor(v, dtype, device) for v in (self.low, self.high))
            return lo + (hi - lo) * eps
        mean = consts.tensor(self.mean, dtype, device)
        std = torch.sqrt(consts.tensor(self.var, dtype, device))
        if self.kind == "multi_gauss":
            mean, std = mean[idx], std[idx]
        return mean + std * eps

    def sample_single(self, key, device="cpu", dtype=torch.float32) -> torch.Tensor:
        """One initial state for a real-system interaction."""
        return self.sample(key, 1, device, dtype)[0]


@dataclasses.dataclass(frozen=True)
class PMSSensors:
    """Partially-measurable-system sensor model used inside rollouts:
    positions measured with Gaussian noise, velocities by causal
    differentiation and an online 1st-order Butterworth low-pass."""

    pos_indices: Tuple[int, ...]
    vel_indices: Tuple[int, ...]
    std_pos_noise: Tuple[float, ...]
    fc: float  # normalized cutoff (Nyquist units) of butter(1, fc)
    dt: float

    def __post_init__(self):
        for f in ("pos_indices", "vel_indices"):
            object.__setattr__(self, f, tuple(int(i) for i in np.asarray(getattr(self, f))))
        object.__setattr__(
            self, "std_pos_noise",
            tuple(float(v) for v in np.asarray(self.std_pos_noise).reshape(-1)),
        )

    def coeffs(self, dtype=torch.float32):
        """butter(1, fc) as Python floats rounded to ``dtype``, the precision
        the rollout computes in."""
        return _butter1_rounded(self.fc, dtype)


@functools.lru_cache(maxsize=None)
def _butter1_rounded(fc, dtype):
    b, a = filters.butter1(fc)
    return (tuple(torch.as_tensor(b, dtype=dtype).tolist()),
            tuple(torch.as_tensor(a, dtype=dtype).tolist()))


class RolloutResult(NamedTuple):
    states: torch.Tensor  # [T, P, ds] true states (the cost reads these)
    inputs: torch.Tensor  # [T, P, du]


class RolloutNoise(NamedTuple):
    """The random numbers of one rollout.

    state: [T-1, P, G] standard normals of the next-state draws;
    keep:  [T, P, num_basis] dropout keep-masks of the policy, or None
           (the policy optimizer's buffers hold the draw's uniforms here
           and form the mask on the device: ``draw_noise(keep_uniforms=)``);
    init:  [P, ds] base draws of the initial particles
           (:meth:`InitialStateDistribution.draw`), or None (read by the
           policy optimizer, not by ``simulate``);
    meas:  [T-1, P, n_pos] standard normals of the simulated position
           measurements (rollouts with sensors only), or None;
    init_idx: [P] component draws of a 'multi_gauss' initial distribution,
           or None.
    Lanes sit behind the time axis: state [T-1, L, P, G], init [L, P, ds],
    init_idx [L, P].
    """

    state: torch.Tensor
    keep: Optional[torch.Tensor] = None
    init: Optional[torch.Tensor] = None
    meas: Optional[torch.Tensor] = None
    init_idx: Optional[torch.Tensor] = None


def stack_lanes(noises) -> RolloutNoise:
    """One lane-batched :class:`RolloutNoise` from one per lane.  Where only
    some lanes have dropout, the others keep every feature."""
    keeps = [n.keep for n in noises]
    if any(k is not None for k in keeps):
        like = next(k for k in keeps if k is not None)
        keeps = [torch.ones_like(like) if k is None else k for k in keeps]
    stack = lambda ts, dim: None if ts[0] is None else torch.stack(ts, dim=dim)
    return RolloutNoise(state=stack([n.state for n in noises], 1), keep=stack(keeps, 1),
                        init=stack([n.init for n in noises], 0),
                        meas=stack([n.meas for n in noises], 1),
                        init_idx=stack([n.init_idx for n in noises], 0))


def _policy_rate(p_dropout, device):
    """The policy's dropout argument: one rate, a tensor [L] of one rate
    per lane as given (the policy optimizer's buffer), or a tensor [L] made
    from a sequence of lane rates that differ."""
    if not isinstance(p_dropout, (list, tuple)):
        return p_dropout
    if len(set(p_dropout)) == 1:
        return float(p_dropout[0])
    return torch.tensor(p_dropout, device=device)


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
    # the 4PMS measurement chain inside every step; None: the policy sees
    # the true state
    sensors: Optional[PMSSensors] = None
    # per-particle state-cotangent norm cap applied once per step; None disables
    bptt_clip: Optional[float] = None
    # cap on the predicted per-step delta in units of the largest training
    # target (Posterior.norm): mean clipped to +-cap*norm, variance to
    # (cap*norm)^2.  Kernels over unbounded features (the Furuta Linear
    # member) grow mean and variance with ||feature||^2 off the data, and
    # one particle that leaves it would blow up the closed-loop rollout; the
    # cap binds only there.  Needs normalize_outputs; None disables.
    delta_cap: Optional[float] = None
    # recompute each step's activations in the backward pass instead of
    # keeping them (``jax.checkpoint`` of the JAX package's scan step)
    remat: bool = False

    def __post_init__(self):
        if self.delta_cap is not None and not self.gp.normalize_outputs:
            raise ValueError(
                "delta_cap is in units of Posterior.norm (the max-abs training target); "
                "with MultiGP(normalize_outputs=False) norm is all-ones and the cap would "
                f"bind at {self.delta_cap} absolute output units. Enable output "
                "normalization or disable delta_cap."
            )

    def _predict(self, gp_params, posterior, gp_in):
        """``gp.predict``, then the ``delta_cap`` clip; ``norm`` [*L, G]
        broadcasts against the [*L, G, P] outputs (restart lanes share a
        posterior: [G] against [R, G, P])."""
        mean, var = self.gp.predict(gp_params, posterior, gp_in)
        if self.delta_cap is None:
            return mean, var
        lim = self.delta_cap * posterior.norm[..., None]
        return torch.clamp(mean, -lim, lim), torch.minimum(var, lim * lim)

    def draw_noise(self, key, num_particles: int, horizon: int, p_dropout, device,
                   dtype=torch.float32, init_dist=None, keep_uniforms=False) -> RolloutNoise:
        """All random numbers of one rollout, one draw per stream, and with
        ``init_dist`` (an :class:`InitialStateDistribution`) those of its
        initial particles (``init``, ``init_idx``).  A list of lane keys (and
        ``p_dropout`` one rate per lane, or one for all) draws every lane from
        its own generators and stacks the lanes.  ``keep_uniforms``: ``keep``
        holds the dropout draw's uniforms instead of its mask (the mask at
        rate p is ``keep < max(1 - p, 1e-6)``), so that the rate can be
        chosen after the draw."""
        if isinstance(key, list):
            rates = p_dropout if isinstance(p_dropout, (list, tuple)) else [p_dropout] * len(key)
            return stack_lanes([self.draw_noise(k, num_particles, horizon, p, device, dtype,
                                                init_dist, keep_uniforms)
                                for k, p in zip(key, rates)])

        def normals(tag, width):
            return torch.randn((horizon - 1, num_particles, width), dtype=dtype, device=device,
                               generator=prng.generator(prng.stream(key, tag), device))

        keep = None
        if p_dropout > 0:
            args = (prng.stream(key, prng.STREAM_DROPOUT),
                    (horizon, num_particles, self.policy.num_basis))
            keep = (self.policy.dropout_uniforms(*args, device) if keep_uniforms
                    else self.policy.dropout_keep(*args, p_dropout, device))
        meas = None
        if self.sensors is not None:
            meas = normals(prng.STREAM_MEAS_NOISE, len(self.sensors.pos_indices))
        init = idx = None
        if init_dist is not None:
            init, idx = init_dist.draw(prng.stream(key, prng.STREAM_INIT_PARTICLES), num_particles,
                                       device, dtype)
        return RolloutNoise(state=normals(prng.STREAM_ROLLOUT, self.gp.num_heads), keep=keep,
                            meas=meas, init=init, init_idx=idx)

    def simulate(self, key, policy_params, gp_params, posterior: Posterior, s0: torch.Tensor,
                 horizon: int, p_dropout=0.0, particle_pred: bool = True,
                 noise: Optional[RolloutNoise] = None) -> RolloutResult:
        """Roll ``s0`` [P, ds] forward ``horizon`` steps (step 0 = s0).

        Lanes: ``s0`` [L, P, ds] with policy parameters [L, ...], ``key`` a
        list of L keys and ``p_dropout`` one rate or one per lane; states and
        inputs come back as [T, L, P, ...].
        """
        if noise is None:
            noise = self.draw_noise(key, s0.shape[-2], horizon, p_dropout, s0.device, s0.dtype)
        rate = _policy_rate(p_dropout, s0.device)

        def policy_at(params, s, t):
            keep = None if noise.keep is None else noise.keep[t]
            return self.policy.apply(params, s, t, p_dropout=rate, keep=keep)

        if self.sensors is not None:
            return self._simulate_pms(policy_at, policy_params, gp_params, posterior, s0,
                                      horizon, particle_pred, noise)

        def step(t, s, u, policy_params, gp_params, posterior):
            if self.bptt_clip is not None:
                s = _clip_bptt(s, self.bptt_clip)
            mean, var = self._predict(gp_params, posterior, self.model.gp_inputs(s, u))
            s, _, _ = self.model.sample_next_state(
                s, u, mean, var, particle_pred=particle_pred, eps=noise.state[t - 1]
            )
            return s, policy_at(policy_params, s, t)

        s, u = s0, policy_at(policy_params, s0, 0)
        states, inputs = [s0], [u]
        for t in range(1, horizon):
            s, u = self._step(step, t, s, u, policy_params, gp_params, posterior)
            states.append(s)
            inputs.append(u)
        return RolloutResult(states=torch.stack(states), inputs=torch.stack(inputs))

    def _step(self, step, *args):
        """``step(*args)``, checkpointed under ``remat`` when a backward pass
        will come.  Everything the gradient flows to (the carried tensors,
        the policy and GP parameters, the posterior) is an argument of
        ``step``.  The step draws no random numbers (they come in through
        :class:`RolloutNoise`), so the recompute needs no saved RNG state."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(step, *args, use_reentrant=False, preserve_rng_state=False)
        return step(*args)

    def _simulate_pms(self, policy_at, policy_params, gp_params, posterior, s0, horizon,
                      particle_pred, noise: RolloutNoise) -> RolloutResult:
        """The rollout with the simulated measurement chain: the policy sees
        noisy positions and filtered finite-difference velocities, the cost
        the true states.  ``noisy`` carries the raw measurement: noisy
        positions, and in the velocity slots the raw differences that the
        next filter step takes as x_{t-1}."""
        sens = self.sensors
        b, a = sens.coeffs(s0.dtype)
        pos, vel = (consts.index(i, s0.device) for i in (sens.pos_indices, sens.vel_indices))
        std_pos = consts.tensor(sens.std_pos_noise, s0.dtype, s0.device)

        def step(t, s, u, noisy_prev, meas_vel_prev, policy_params, gp_params, posterior):
            if self.bptt_clip is not None:
                s = _clip_bptt(s, self.bptt_clip)
                noisy_prev = _clip_bptt(noisy_prev, self.bptt_clip)
                meas_vel_prev = _clip_bptt(meas_vel_prev, self.bptt_clip)
            mean, var = self._predict(gp_params, posterior, self.model.gp_inputs(s, u))
            s, _, _ = self.model.sample_next_state(
                s, u, mean, var, particle_pred=particle_pred, eps=noise.state[t - 1]
            )
            meas, noisy_prev, meas_vel_prev = filters.pms_measure(
                b, a, s, s[..., pos] + std_pos * noise.meas[t - 1], noisy_prev, meas_vel_prev,
                sens.pos_indices, sens.vel_indices, sens.dt,
            )
            return s, policy_at(policy_params, meas, t), noisy_prev, meas_vel_prev

        # at t=0 the measurement equals the true state
        s, noisy_prev, meas_vel_prev = s0, s0, s0[..., vel]
        u = policy_at(policy_params, s0, 0)
        states, inputs = [s0], [u]
        for t in range(1, horizon):
            s, u, noisy_prev, meas_vel_prev = self._step(
                step, t, s, u, noisy_prev, meas_vel_prev, policy_params, gp_params, posterior)
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
            mean, var = self._predict(gp_params, posterior, self.model.gp_inputs(s, u))
            s, _, _ = self.model.sample_next_state(s, u, mean, var, particle_pred=False)
            traj.append(s[0])
        return torch.stack(traj)
