"""A MuJoCo plant behind the same ``TrialData`` protocol as the ODE plants.

The counterpart of ``mcpilco_tpu/envs/mujoco_plant.py``: the simulator runs
on the host (it is the "real system"), ``frame_skip = dt / sim_timestep``
physics sub-steps per control step, observation [qpos, qvel], and the
policy acts on the noisy observation, one ``apply`` per control step on the
agent's device.  ``mujoco`` is imported only when a rollout runs, so the
scenarios that hold a plant build without it (the card's machine has none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ..utils import prng
from .plants import TrialData

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def _require_mujoco():
    try:
        import mujoco
    except ImportError as e:
        raise ImportError("MujocoPlant needs the `mujoco` package (pip install mujoco)") from e
    return mujoco


@dataclasses.dataclass(frozen=True)
class MujocoPlant:
    """Host-side MuJoCo system.

    xml: path to the model XML (absolute, or a name in ``envs/assets/``).
    noise_std: per-dim Gaussian measurement noise on [qpos, qvel].
    """

    xml: str
    noise_std: Tuple[float, ...] = ()
    sim_timestep: float = 0.01

    def __post_init__(self):
        object.__setattr__(
            self, "noise_std", tuple(float(v) for v in np.asarray(self.noise_std).reshape(-1))
        )

    def _load(self):
        mujoco = _require_mujoco()
        path = self.xml if os.path.isabs(self.xml) else os.path.join(ASSETS, self.xml)
        model = mujoco.MjModel.from_xml_path(path)
        if abs(model.opt.timestep - self.sim_timestep) > 1e-12:
            model.opt.timestep = self.sim_timestep
        return mujoco, model

    @torch.no_grad()
    def rollout(self, key, s0, policy, policy_params, T: float, dt: float,
                device="cuda") -> TrialData:
        """Simulate ``T`` seconds at sampling time ``dt``: N = T/dt control
        steps, N + 1 samples, and a final input at the last sample so that
        there are as many inputs as states."""
        mujoco, model = self._load()
        data = mujoco.MjData(model)
        nq = model.nq
        frame_skip = max(1, int(round(dt / model.opt.timestep)))
        num_steps = int(round(T / dt))

        s0 = np.asarray(s0, np.float64)
        data.qpos[:] = s0[:nq]
        data.qvel[:] = s0[nq:]
        mujoco.mj_forward(model, data)

        # measurement noise of every sample, drawn up front on the host
        noise = np.asarray(self.noise_std) if self.noise_std else np.zeros(2 * nq)
        eps = torch.randn((num_steps + 1, 2 * nq), dtype=torch.float64,
                          generator=prng.generator(prng.stream(key, prng.STREAM_MEAS_NOISE),
                                                   "cpu")).numpy()
        k_pol = prng.stream(key, prng.STREAM_EXPLORATION)

        def act(s, t):
            x = torch.as_tensor(np.asarray(s, np.float32), device=device)[None, :]
            u = policy.apply(policy_params, x, t, key=prng.fold(k_pol, t))[0]
            return u.cpu().numpy().astype(np.float64)

        def obs():
            return np.concatenate([data.qpos, data.qvel])

        states = [obs()]
        noisy = [states[0] + eps[0] * noise]
        inputs = []
        for t in range(num_steps):
            u = act(noisy[t], t)
            inputs.append(u)
            data.ctrl[:] = u
            for _ in range(frame_skip):
                mujoco.mj_step(model, data)
            states.append(obs())
            noisy.append(states[-1] + eps[t + 1] * noise)
        inputs.append(act(noisy[-1], num_steps))
        m = np.asarray(noisy, np.float32)
        return TrialData(
            measured=m,
            inputs=np.asarray(inputs, np.float32),
            true=np.asarray(states, np.float32),
            noisy=m,
        )
