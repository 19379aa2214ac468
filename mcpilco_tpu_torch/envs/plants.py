"""The "real system" protocol: plant rollouts that produce trial data.

A plant exposes ``rollout(key, s0, policy, policy_params, T, dt, device)
-> TrialData``; the policy acts on *measured* states.  :class:`ODEPlant`
adds Gaussian measurement noise on all dims (``mcpilco_tpu/envs/plants.py``).
The plant runs on ``device`` as a Python loop over control steps; it is not
hot (one trial per policy optimization).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

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

    @torch.no_grad()
    def rollout(self, key, s0, policy, policy_params, T: float, dt: float,
                device="cpu") -> TrialData:
        """Simulate ``T`` seconds at sampling time ``dt`` (N = T/dt + 1 samples)."""
        num_steps = int(round(T / dt))
        s = torch.as_tensor(np.asarray(s0), dtype=torch.float32, device=device)
        noise_std = torch.as_tensor(self.noise_std, dtype=s.dtype, device=device)
        k_pol = prng.stream(key, prng.STREAM_EXPLORATION)
        meas_noise = noise_std * torch.randn(
            (num_steps + 1,) + tuple(s.shape), dtype=s.dtype, device=device,
            generator=prng.generator(prng.stream(key, prng.STREAM_MEAS_NOISE), device),
        )
        meas = s + meas_noise[0]
        states, measured, inputs = [s], [meas], []
        for i in range(num_steps + 1):
            u = policy.apply(policy_params, meas[None, :], i, key=prng.fold(k_pol, i))[0]
            inputs.append(u)
            if i == num_steps:
                break
            s = ode_mod.integrate(self.ode, s, u, dt, self.substeps)
            meas = s + meas_noise[i + 1]
            states.append(s)
            measured.append(meas)
        m = torch.stack(measured).cpu().numpy()
        return TrialData(measured=m, inputs=torch.stack(inputs).cpu().numpy(),
                         true=torch.stack(states).cpu().numpy(), noisy=m)
