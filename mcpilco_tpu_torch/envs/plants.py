"""The "real system" protocol: plant rollouts that produce trial data.

A plant exposes ``rollout(key, s0, policy, policy_params, T, dt, device)
-> TrialData``, on the card unless ``device`` says otherwise; the policy
acts on *measured* states (``mcpilco_tpu/envs/plants.py``):

- :class:`ODEPlant` adds Gaussian measurement noise on all dims;
- :class:`PMSODEPlant` measures positions with noise and estimates
  velocities by causal differences and an online 1st-order Butterworth.

The plant runs on ``device`` as a Python loop over control steps; it is not
hot (one trial per policy optimization).  ``rollout_lanes`` of either
plant rolls the trials of several seeds through one RK4 loop.
:func:`offline_velocity_estimation` is the host-side data prep of 4PMS
model learning, :func:`offline_velocity_estimation_lanes` the seed farm's,
on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import filters
from ..utils import prng
from . import ode as ode_mod


class TrialData(NamedTuple):
    """One system interaction (host arrays).

    measured: [N, ds] what the policy saw / what gets modeled
    inputs:   [N, du]
    true:     [N, ds] noiseless simulator states
    noisy:    [N, ds] raw noisy measurements (= measured for this plant)
    """

    measured: np.ndarray
    inputs: np.ndarray
    true: np.ndarray
    noisy: np.ndarray


@dataclasses.dataclass(frozen=True)
class ODEPlant:
    """Fully-measurable ODE plant with per-dim measurement noise std."""

    ode_name: str
    noise_std: Tuple[float, ...] = ()
    substeps: int = 20

    def __post_init__(self):
        object.__setattr__(self, "noise_std", tuple(float(v) for v in np.asarray(self.noise_std).reshape(-1)))

    @property
    def ode(self) -> Callable:
        return ode_mod.REGISTRY[self.ode_name]

    def rollout(self, key, s0, policy, policy_params, T: float, dt: float,
                device="cuda") -> TrialData:
        """Simulate ``T`` seconds at sampling time ``dt`` (N = T/dt + 1 samples)."""
        lanes = self.rollout_lanes([key], np.asarray(s0)[None], policy,
                                   {k: v[None] for k, v in policy_params.items()}, T, dt, device)
        return TrialData(*(a[0] for a in lanes))

    @torch.no_grad()
    def rollout_lanes(self, keys, s0, policy, policy_params, T: float, dt: float,
                      device="cuda") -> TrialData:
        """One trial for each of L seeds, integrated together: ``keys`` one
        key per seed, ``s0`` [L, ds], ``policy_params`` [L, ...].  Each seed
        draws its noise and actions from its own key exactly as
        :meth:`rollout` does.  Returns arrays [L, N, ...]."""
        num_steps = int(round(T / dt))
        s = torch.as_tensor(np.asarray(s0), dtype=torch.float32, device=device)
        noise_std = torch.as_tensor(self.noise_std, dtype=s.dtype, device=device)
        k_pol = [prng.stream(k, prng.STREAM_EXPLORATION) for k in keys]
        meas_noise = noise_std * torch.stack([
            torch.randn((num_steps + 1, s.shape[-1]), dtype=s.dtype, device=device,
                        generator=prng.generator(prng.stream(k, prng.STREAM_MEAS_NOISE), device))
            for k in keys
        ], dim=1)
        lane = [{k: v[i] for k, v in policy_params.items()} for i in range(len(keys))]
        meas = s + meas_noise[0]
        states, measured, inputs = [s], [meas], []
        for i in range(num_steps + 1):
            u = torch.stack([policy.apply(lane[j], meas[j][None, :], i, key=prng.fold(k_pol[j], i))[0]
                             for j in range(len(keys))])
            inputs.append(u)
            if i == num_steps:
                break
            s = ode_mod.integrate(self.ode, s, u, dt, self.substeps)
            meas = s + meas_noise[i + 1]
            states.append(s)
            measured.append(meas)
        host = lambda xs: torch.stack(xs, dim=1).cpu().numpy()
        m = host(measured)
        return TrialData(measured=m, inputs=host(inputs), true=host(states), noisy=m)


@dataclasses.dataclass(frozen=True)
class PMSODEPlant(ODEPlant):
    """Partially-measurable ODE plant: the policy sees noisy positions and
    online-filtered finite-difference velocities."""

    pos_indices: Tuple[int, ...] = ()
    vel_indices: Tuple[int, ...] = ()
    fc: float = 0.5  # online butter(1, fc) cutoff

    def __post_init__(self):
        super().__post_init__()
        for f in ("pos_indices", "vel_indices"):
            object.__setattr__(self, f, tuple(int(i) for i in np.asarray(getattr(self, f))))

    def rollout(self, key, s0, policy, policy_params, T: float, dt: float, device="cuda",
                eps: Optional[torch.Tensor] = None) -> TrialData:
        """Simulate ``T`` seconds at sampling time ``dt`` (N = T/dt + 1
        samples).  ``eps`` [N-1, ds] replaces the standard-normal draws of
        samples 1..N-1; only the position dims of each draw are used."""
        lanes = self.rollout_lanes([key], np.asarray(s0)[None], policy,
                                   {k: v[None] for k, v in policy_params.items()}, T, dt, device,
                                   eps=None if eps is None else eps[None])
        return TrialData(*(a[0] for a in lanes))

    @torch.no_grad()
    def rollout_lanes(self, keys, s0, policy, policy_params, T: float, dt: float,
                      device="cuda", eps: Optional[torch.Tensor] = None) -> TrialData:
        """One trial for each of L seeds, integrated together: ``keys`` one
        key per seed, ``s0`` [L, ds], ``policy_params`` [L, ...], ``eps``
        [L, N-1, ds] or None.  Each seed draws its measurement noise and
        actions from its own key exactly as :meth:`rollout` does.  Returns
        arrays [L, N, ...]."""
        num_steps = int(round(T / dt))
        b, a = filters.butter1(self.fc)
        pos, vel = list(self.pos_indices), list(self.vel_indices)
        s = torch.as_tensor(np.asarray(s0), dtype=torch.float32, device=device)
        noise_std = torch.as_tensor(self.noise_std, dtype=s.dtype, device=device)
        k_pol = [prng.stream(k, prng.STREAM_EXPLORATION) for k in keys]
        if eps is None:
            eps = torch.stack([torch.randn(
                (num_steps, s.shape[-1]), dtype=s.dtype, device=device,
                generator=prng.generator(prng.stream(k, prng.STREAM_MEAS_NOISE), device))
                for k in keys])
        meas_noise = noise_std * eps.to(device=device, dtype=s.dtype)  # [L, N-1, ds]
        lane = [{k: v[i] for k, v in policy_params.items()} for i in range(len(keys))]
        # at t=0 the raw and the filtered measurement both equal s0
        noisy_prev, meas_prev = s, s
        states, noisy_all, measured, inputs = [s], [s], [s], []
        for i in range(num_steps + 1):
            u = torch.stack([policy.apply(lane[j], meas_prev[j][None, :], i,
                                          key=prng.fold(k_pol[j], i))[0]
                             for j in range(len(keys))])
            inputs.append(u)
            if i == num_steps:
                break
            s = ode_mod.integrate(self.ode, s, u, dt, self.substeps)
            meas_prev, noisy_prev, _ = filters.pms_measure(
                b, a, s, s[:, pos] + meas_noise[:, i][:, pos], noisy_prev, meas_prev[:, vel],
                pos, vel, dt)
            states.append(s)
            noisy_all.append(noisy_prev)
            measured.append(meas_prev)
        host = lambda xs: torch.stack(xs, dim=1).cpu().numpy()
        return TrialData(measured=host(measured), inputs=host(inputs), true=host(states),
                         noisy=host(noisy_all))


def _savgol_fit_matrix(n: int, window: int, polyorder: int, deriv: int,
                       delta: float) -> np.ndarray:
    """[n, n] matrix A such that (A @ y) is the Savitzky-Golay estimate of
    the ``deriv``-th derivative of y sampled at spacing ``delta``: centered
    least-squares fits inside, and at the first/last ``window//2`` rows the
    polynomial of the first/last full window (scipy's ``mode='interp'``)."""
    if window % 2 != 1 or window > n:
        raise ValueError(f"savgol window must be odd and <= n, got {window} (n={n})")
    if polyorder >= window:
        raise ValueError("savgol polyorder must be < window")
    half = window // 2
    fact = np.array([math.factorial(j) / math.factorial(j - deriv)
                     if j >= deriv else 0.0 for j in range(polyorder + 1)])

    def eval_row(offsets, x):
        V = np.vander(np.asarray(offsets, np.float64), polyorder + 1, increasing=True)
        powers = np.array([x ** (j - deriv) if j >= deriv else 0.0
                           for j in range(polyorder + 1)])
        return (fact * powers) @ np.linalg.pinv(V)

    A = np.zeros((n, n))
    center = eval_row(np.arange(-half, half + 1), 0.0)
    for i in range(half, n - half):
        A[i, i - half:i + half + 1] = center
    for i in range(half):
        A[i, :window] = eval_row(np.arange(window), float(i))
        j = n - 1 - i
        A[j, n - window:] = eval_row(np.arange(window), float(window - 1 - i))
    return A / delta**deriv


def _savgol_pos_vel(n: int, dt: float, window: int, polyorder: int):
    return (_savgol_fit_matrix(n, window, polyorder, 0, dt),
            _savgol_fit_matrix(n, window, polyorder, 1, dt))


def offline_velocity_estimation(noisy: np.ndarray, inputs: np.ndarray, dt: float, pos_indices,
                                vel_indices, filt_order: int = 2, filt_cutoff: float = 0.5,
                                method: str = "butter_cd", savgol_window: int = 7,
                                savgol_polyorder: int = 5):
    """Offline state estimation for model training, on the host: positions
    smoothed and velocities estimated from the noisy positions, then the
    first and last samples trimmed.  Returns (states [N-2, ds], inputs[1:-1]).

    ``method='butter_cd'``: zero-phase Butterworth (float32 ``filtfilt``) on
    positions, central-difference velocities of those (float32 arithmetic,
    as numpy does it in the JAX host path), stored in a float64 array.
    ``method='savgol'``: float64 Savitzky-Golay fit matrices (deriv 0 for
    positions, 1 for velocities).
    """
    n = noisy.shape[0]
    out = np.zeros((n - 2, noisy.shape[1]))
    if method == "savgol":
        smooth, diff = _savgol_pos_vel(n, dt, savgol_window, savgol_polyorder)
        for p_i, v_i in zip(pos_indices, vel_indices):
            out[:, p_i] = (smooth @ noisy[:, p_i])[1:-1]
            out[:, v_i] = (diff @ noisy[:, p_i])[1:-1]
        return out, inputs[1:-1, :]
    if method != "butter_cd":
        raise ValueError(f"unknown offline filter method {method!r}")
    b, a = filters.butter2(filt_cutoff) if filt_order == 2 else filters.butter1(filt_cutoff)
    for p_i, v_i in zip(pos_indices, vel_indices):
        x = torch.as_tensor(np.asarray(noisy[:, p_i], np.float32))
        pos = filters.filtfilt(b, a, x).numpy()
        out[:, p_i] = pos[1:-1]
        out[:, v_i] = (pos[2:] - pos[:-2]) / (2.0 * dt)
    return out, inputs[1:-1, :]


def offline_velocity_estimation_lanes(noisy: torch.Tensor, inputs: torch.Tensor, dt: float,
                                      pos_indices, vel_indices, filt_order: int = 2,
                                      filt_cutoff: float = 0.5, method: str = "butter_cd",
                                      savgol_window: int = 7, savgol_polyorder: int = 5):
    """The offline state estimation of L trials at once, in float32 on the
    device of ``noisy`` (``offline_velocity_estimation_jax`` of
    ``mcpilco_tpu/envs/plants.py``, which the JAX seed farm ``vmap``s):
    ``noisy`` [L, N, ds], ``inputs`` [L, N, du].  Returns (states [L, N-2,
    ds], inputs [L, N-2, du]); the columns that are neither positions nor
    velocities are zero.

    ``method='butter_cd'``: zero-phase Butterworth on the positions (time on
    dim 0, the lanes and position columns behind it, as :func:`filters.
    filtfilt` takes them), central-difference velocities of those.
    ``method='savgol'``: the Savitzky-Golay fit matrices in float32.
    """
    pos, vel = list(pos_indices), list(vel_indices)
    noisy = noisy.to(torch.float32)
    x = noisy[:, :, pos]  # [L, N, n_pos]
    n = noisy.shape[1]
    if method == "savgol":
        smooth, diff = (torch.as_tensor(m, dtype=noisy.dtype, device=noisy.device)
                        for m in _savgol_pos_vel(n, dt, savgol_window, savgol_polyorder))
        pos_f = smooth @ x
        v = (diff @ x)[:, 1:-1]
    elif method == "butter_cd":
        b, a = filters.butter2(filt_cutoff) if filt_order == 2 else filters.butter1(filt_cutoff)
        pos_f = filters.filtfilt(b, a, x.transpose(0, 1)).transpose(0, 1)
        v = (pos_f[:, 2:] - pos_f[:, :-2]) / (2.0 * dt)
    else:
        raise ValueError(f"unknown offline filter method {method!r}")
    out = noisy.new_zeros((noisy.shape[0], n - 2, noisy.shape[2]))
    out[:, :, pos] = pos_f[:, 1:-1]
    out[:, :, vel] = v
    return out, inputs[:, 1:-1]
