"""Control and exploration policies as functions of parameter dicts.

Every policy is a static config object with (``mcpilco_tpu/models/policies.py``):

- ``init_params(key, device, dtype) -> params`` (empty dict if parameter-free)
- ``apply(params, states, t, key=None, p_dropout=0.0, keep=None) -> actions``,
  batched over a leading particle axis and differentiable w.r.t. ``params``
  and ``states``.  ``key`` is a ``utils.prng`` key; ``keep`` is an optional
  dropout keep-mask that replaces the draw, so tests can share it.
- ``param_mask(params)`` and ``reinit(params, key)``;
- ``host_policy(params)``: a numpy closure (state, t) -> action for
  host-side plants.

Lanes (restart lanes, the seed farm's seeds): :class:`SumOfGaussians` takes
parameters with a leading lane axis [L, ...] and states [L, P, ds], a
dropout rate per lane, and ``reinit`` with one key per lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import consts, prng
from .kernels import _as_tuple


def squash(u: torch.Tensor, u_max) -> torch.Tensor:
    """Smoothly constrain inputs to (-u_max, u_max)."""
    um = consts.tensor(u_max, u.dtype, u.device)
    return um * torch.tanh(u / um)


def _umax_static(u_max):
    a = np.asarray(u_max, float)
    return float(a) if a.ndim == 0 else tuple(float(x) for x in a.reshape(-1))


class PolicyBase:
    """Static config base class; see module docstring for the contract."""

    input_dim: int

    def init_params(self, key, device="cpu", dtype=torch.float32) -> dict:
        return {}

    def param_mask(self, params):
        return {k: False for k in params}

    def apply(self, params, states, t, key=None, p_dropout=0.0, keep=None):
        raise NotImplementedError

    def reinit(self, params, key):
        return params

    def host_policy(self, params):
        """NumPy-facing closure for host-side plant rollouts: a state [ds]
        and a step t in, the action [du] out, computed on the parameters'
        device without a key (no dropout, no dither)."""
        leaves = [v for v in params.values() if torch.is_tensor(v)]
        device = leaves[0].device if leaves else torch.device("cpu")

        @torch.no_grad()
        def np_policy(state, t):
            s = torch.as_tensor(np.asarray(state, np.float32), device=device)[None, :]
            return self.apply(params, s, int(round(t)))[0].cpu().numpy()

        return np_policy


def _clamp_step(t, n: int) -> int:
    """A time index clamped into [0, n-1], as a JAX gather clamps it."""
    return min(max(int(t), 0), n - 1)


class _TargetTrajectory:
    """A static target trajectory ``target_traj`` (a tuple of rows) read at
    a clamped time index; its tensor is made once per dtype and device."""

    target_traj: Tuple[Tuple[float, ...], ...]

    def _store_traj(self):
        tt = tuple(tuple(float(v) for v in row) for row in np.asarray(self.target_traj))
        object.__setattr__(self, "target_traj", tt)

    def _traj(self, dtype, device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_traj_cache", {})
        k = (dtype, torch.device(device))
        if k not in cache:
            cache[k] = torch.tensor(self.target_traj, dtype=dtype, device=device)
        return cache[k]

    def _target(self, t, like: torch.Tensor) -> torch.Tensor:
        traj = self._traj(like.dtype, like.device)
        return traj[_clamp_step(t, traj.shape[0])]


@dataclasses.dataclass(frozen=True)
class RandomExploration(PolicyBase):
    """Uniform random action in (-u_max, u_max) each step, squashed."""

    state_dim: int
    input_dim: int
    u_max: float = 1.0

    def apply(self, params, states, t, key=None, p_dropout=0.0, keep=None):
        if key is None:
            raise ValueError("RandomExploration needs a key")
        gen = prng.generator(prng.fold(key, t), states.device)
        u = torch.rand(states.shape[:-1] + (self.input_dim,), generator=gen,
                       dtype=states.dtype, device=states.device)
        return squash(self.u_max * (2.0 * u - 1.0), self.u_max)


@dataclasses.dataclass(frozen=True)
class SumOfSinusoids(PolicyBase):
    """Sum of ``num_sin`` sinusoids with random amplitudes, frequencies
    (rad/s) and phases, drawn once by ``init_params`` and then frozen.  ``t``
    is the step index; ``dt`` converts it to seconds."""

    state_dim: int
    input_dim: int
    num_sin: int
    omega_min: float
    omega_max: float
    amplitude_min: float
    amplitude_max: float
    squash_output: bool = False
    u_max: float = 1.0
    dt: float = 1.0

    def init_params(self, key, device="cpu", dtype=torch.float32) -> dict:
        gen = prng.generator(key, device)
        shape = (self.num_sin, self.input_dim)

        def uniform():
            return torch.rand(shape, generator=gen, dtype=dtype, device=device)

        def sign():
            return torch.where(uniform() < 0.5, 1.0, -1.0).to(dtype)

        amp = self.amplitude_min + (self.amplitude_max - self.amplitude_min) * uniform()
        omega = sign() * (self.omega_min + (self.omega_max - self.omega_min) * uniform())
        phase = sign() * np.pi * (uniform() - 0.5)
        return {"amplitudes": amp, "omega": omega, "phases": phase}

    def apply(self, params, states, t, key=None, p_dropout=0.0, keep=None):
        tt = torch.as_tensor(t, dtype=states.dtype) * self.dt
        u = torch.sum(params["amplitudes"] * torch.sin(params["omega"] * tt + params["phases"]),
                      dim=0)
        u = u.expand(states.shape[:-1] + (self.input_dim,))
        return squash(u, self.u_max) if self.squash_output else u


@dataclasses.dataclass(frozen=True)
class SumOfGaussians(PolicyBase):
    """The trainable controller: squashed RBF network with feature dropout,
    u = squash(W @ dropout(exp(-||(s/scale - c)/l||^2)))."""

    feature_dim: int
    input_dim: int
    num_basis: int
    u_max: float = 1.0
    squash_output: bool = True
    use_bias: bool = False
    train_lengthscales: bool = True
    train_centers: bool = True
    train_weight: bool = True
    train_bias: bool = False
    centers_init_min: float = -1.0
    centers_init_max: float = 1.0
    scale_factor: Optional[Tuple[float, ...]] = None
    reinit_lengthscales: Optional[Tuple[float, ...]] = None
    reinit_centers: Optional[Tuple[float, ...]] = None
    reinit_weight: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "u_max", _umax_static(self.u_max))
        for f in ("scale_factor", "reinit_lengthscales", "reinit_centers"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(float(x) for x in np.asarray(v).reshape(-1)))

    def _umax_col(self, dtype, device):
        um = torch.as_tensor(self.u_max, dtype=dtype, device=device)
        return um.reshape(-1, 1) if um.ndim else um

    def init_params(self, key, lengthscales=None, centers=None, weight=None, bias=None,
                    device="cpu", dtype=torch.float32) -> dict:
        opts = dict(dtype=dtype, device=device)
        gen = prng.generator(key, device)
        nf, nb = self.feature_dim, self.num_basis
        ls = torch.ones(nf, **opts)
        if lengthscales is not None:
            ls = ls * torch.as_tensor(lengthscales, **opts)
        if centers is None:
            centers = self.centers_init_min + (self.centers_init_max - self.centers_init_min) * (
                torch.rand((nb, nf), generator=gen, **opts)
            )
        if weight is None:
            weight = self._umax_col(dtype, device) * (
                torch.rand((self.input_dim, nb), generator=gen, **opts) - 0.5
            )
        p = {
            "log_lengthscales": torch.log(ls),
            "centers": torch.as_tensor(centers, **opts),
            "weight": torch.as_tensor(weight, **opts),
        }
        if self.use_bias:
            p["bias"] = torch.zeros(self.input_dim, **opts) if bias is None else torch.as_tensor(bias, **opts)
        return p

    def param_mask(self, params):
        m = {
            "log_lengthscales": self.train_lengthscales,
            "centers": self.train_centers,
            "weight": self.train_weight,
        }
        if "bias" in params:
            m["bias"] = self.train_bias
        return m

    def reinit(self, params, key):
        """Randomized re-init on NaN: centers ~ c*2(U-.5), weight ~ w*(U-.5),
        lengthscales reset to the configured values.  Lane params [L, ...]
        take a sequence of L keys, each lane drawing from its own."""
        if params["centers"].dim() == 3:
            lanes = [self.reinit({k: v[i] for k, v in params.items()}, k_i)
                     for i, k_i in enumerate(key)]
            return {k: torch.stack([p[k] for p in lanes]) for k in params}
        c = params["centers"]
        opts = dict(dtype=c.dtype, device=c.device)
        gen = prng.generator(key, c.device)
        if self.reinit_lengthscales is not None:
            ls = torch.as_tensor(self.reinit_lengthscales, **opts) * torch.ones(self.feature_dim, **opts)
        else:
            ls = torch.exp(params["log_lengthscales"])
        c_mag = torch.as_tensor(
            self.reinit_centers if self.reinit_centers is not None else (1.0,) * self.feature_dim,
            **opts,
        )
        w_mag = torch.as_tensor(
            self.reinit_weight if self.reinit_weight is not None else self.u_max, **opts
        )
        w_mag = w_mag.reshape(-1, 1) if w_mag.ndim else w_mag
        new = dict(params)
        new["log_lengthscales"] = torch.log(ls)
        new["centers"] = c_mag * 2.0 * (torch.rand(c.shape, generator=gen, **opts) - 0.5)
        new["weight"] = w_mag * (torch.rand(params["weight"].shape, generator=gen, **opts) - 0.5)
        return new

    def features(self, params, policy_in):
        """exp(-squared distance to centers): [..., num_basis]."""
        if self.scale_factor is not None:
            policy_in = policy_in / consts.tensor(self.scale_factor, policy_in.dtype,
                                                  policy_in.device)
        ls = torch.exp(params["log_lengthscales"])[..., None, :]  # [*L, 1, nf]
        s = policy_in / ls
        c = params["centers"] / ls
        # direct differences: cancellation-free (see kernels.sq_dist)
        diff = s[..., :, None, :] - c[..., None, :, :]
        return torch.exp(-torch.sum(diff * diff, dim=-1))

    def _policy_input(self, states, t):
        return states

    def dropout_uniforms(self, key, shape, device):
        """The uniforms of one dropout draw: a feature is kept where its
        uniform is below the keep-probability."""
        return torch.rand(shape, generator=prng.generator(key, device), device=device)

    def dropout_keep(self, key, shape, p_dropout, device):
        """The Bernoulli keep-mask of one dropout draw."""
        return self.dropout_uniforms(key, shape, device) < max(1.0 - p_dropout, 1e-6)

    def apply(self, params, states, t, key=None, p_dropout=0.0, keep=None):
        """``p_dropout`` is one rate, or a tensor [L] of one rate per lane,
        which needs ``keep`` (lanes at rate 0 keep every feature)."""
        feats = self.features(params, self._policy_input(states, t))
        if torch.is_tensor(p_dropout):
            keep_prob = torch.clamp(1.0 - p_dropout, min=1e-6)
            feats = feats * keep.to(feats.dtype) / keep_prob.reshape((-1,) + (1,) * (feats.dim() - 1))
        elif p_dropout > 0 and (key is not None or keep is not None):
            p = float(p_dropout)
            if keep is None:
                keep = self.dropout_keep(key, feats.shape, p, feats.device)
            # inverted dropout: rescale the kept features by 1 / keep-prob
            feats = feats * keep.to(feats.dtype) / max(1.0 - p, 1e-6)
        u = torch.matmul(feats, params["weight"].mT)
        if "bias" in params:
            u = u + params["bias"][..., None, :]
        return squash(u, self.u_max) if self.squash_output else u


@dataclasses.dataclass(frozen=True)
class SumOfGaussiansWithAngles(SumOfGaussians):
    """Angle dims mapped to (cos, sin) before the RBF net.
    ``feature_dim`` must equal state_dim + len(angle_indices)."""

    angle_indices: Tuple[int, ...] = ()
    non_angle_indices: Tuple[int, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "angle_indices", _as_tuple(self.angle_indices))
        object.__setattr__(self, "non_angle_indices", _as_tuple(self.non_angle_indices))

    def _policy_input(self, states, t):
        ang = states[..., consts.index(self.angle_indices, states.device)]
        rest = states[..., consts.index(self.non_angle_indices, states.device)]
        return torch.cat([rest, torch.cos(ang), torch.sin(ang)], dim=-1)


@dataclasses.dataclass(frozen=True)
class SumOfGaussiansTracking(_TargetTrajectory, SumOfGaussians):
    """Time-indexed tracking policy: the RBF network on [s, target(t) - s].
    ``feature_dim`` must equal 2 * state_dim; the target trajectory is
    static data given at construction, indexed at t clamped into it."""

    target_traj: Tuple[Tuple[float, ...], ...] = ()

    def __post_init__(self):
        super().__post_init__()
        self._store_traj()

    def _policy_input(self, states, t):
        target = self._target(t, states)
        return torch.cat([states, target - states], dim=-1)


@dataclasses.dataclass(frozen=True)
class PDController(_TargetTrajectory, PolicyBase):
    """PD tracking controller u = squash(Kp^2 e_pos + Kd^2 e_vel) against a
    reference trajectory, e = target(t) - s with t clamped into it.
    ``noise_std`` > 0 adds an exploration dither noise_std * N(0, 1) before
    the squash, drawn from ``fold(key, 0x9D)`` (only with a key), so that
    the GP sees the torque dims beyond the exact PD law."""

    state_dim: int
    input_dim: int
    target_traj: Tuple[Tuple[float, ...], ...] = ()
    u_max: float = 1.0
    trainable: bool = False
    noise_std: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "u_max", _umax_static(self.u_max))
        self._store_traj()

    def init_params(self, key, sqrt_kp=None, sqrt_kd=None, device="cpu",
                    dtype=torch.float32) -> dict:
        opts = dict(dtype=dtype, device=device)
        half = self.state_dim // 2
        kp = torch.ones(half, **opts) if sqrt_kp is None else torch.as_tensor(sqrt_kp, **opts)
        kd = torch.ones(half, **opts) if sqrt_kd is None else torch.as_tensor(sqrt_kd, **opts)
        return {"sqrt_kp": kp, "sqrt_kd": kd}

    def param_mask(self, params):
        return {"sqrt_kp": self.trainable, "sqrt_kd": self.trainable}

    def apply(self, params, states, t, key=None, p_dropout=0.0, keep=None, dither=None):
        """``dither`` [..., du] standard normals replace the draw from
        ``key`` (tests hand in JAX's)."""
        err = self._target(t, states) - states
        half = self.state_dim // 2
        u = params["sqrt_kp"] ** 2 * err[..., :half] + params["sqrt_kd"] ** 2 * err[..., half:]
        if self.noise_std > 0 and (dither is not None or key is not None):
            if dither is None:
                dither = torch.randn(u.shape, dtype=u.dtype, device=u.device,
                                     generator=prng.generator(prng.fold(key, 0x9D), u.device))
            u = u + self.noise_std * dither
        return squash(u, self.u_max)
