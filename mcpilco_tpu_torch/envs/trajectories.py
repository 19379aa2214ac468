"""Reference joint trajectories for tracking tasks.

A copy of ``mcpilco_tpu/envs/trajectories.py``: the UR5 tracking target is
*generated* in numpy, a quintic-blended multi-sine in joint space with
analytically consistent velocities, columns [q_r(6), qd_r(6)].  The
recorded 200 x 12 reference CSV of the original task is data read at run
time from a reference checkout; this package ships no such file.
"""

from __future__ import annotations

import os

import numpy as np


def reference_file(*parts: str, what: str) -> str:
    """The path of a file of the original task's checkout, whose root is
    ``$MCPILCO_REFERENCE``; raises ``FileNotFoundError`` naming the file
    (``what`` says what needs it) when the variable is unset or the file is
    absent."""
    root = os.environ.get("MCPILCO_REFERENCE")
    path = os.path.join(root or "$MCPILCO_REFERENCE", *parts)
    if not root or not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} needs {path} from the original task's checkout; set MCPILCO_REFERENCE "
            "to the checkout that holds it"
        )
    return path


def ur5_reference_trajectory(num_steps: int = 200, dt: float = 0.02) -> np.ndarray:
    """The original task's recorded trajectory, read at run time from
    ``$MCPILCO_REFERENCE/envs/target_q_trajectory.csv`` (raises
    ``FileNotFoundError`` naming the CSV when it is absent); ``dt`` must be
    the recording's 0.02 s."""
    if abs(dt - 0.02) > 1e-9:
        raise ValueError(
            f"the reference trajectory is recorded at dt=0.02s (50 Hz); got dt={dt}"
        )
    path = reference_file("envs", "target_q_trajectory.csv",
                          what="trajectory='reference' (a [T, 12] array [q_r, qd_r] at 50 Hz)")
    traj = np.genfromtxt(path, delimiter=",").astype(np.float32)
    if traj.ndim != 2 or traj.shape[1] != 12:
        raise ValueError(f"expected a [T, 12] trajectory at {path}, got {traj.shape}")
    if num_steps > traj.shape[0]:
        raise ValueError(
            f"reference trajectory has {traj.shape[0]} steps; {num_steps} requested"
        )
    return traj[:num_steps]


def ur5_joint_trajectory(
    num_steps: int = 200,
    dt: float = 0.02,
    num_joints: int = 6,
    amplitude: float = 0.6,
    seed: int = 0,
) -> np.ndarray:
    """Returns [num_steps, 2*num_joints]: columns [q_r(6), qd_r(6)].

    Each joint follows a_j * s(t) * sin(w_j t + p_j) where s(t) is a smooth
    start ramp, so the trajectory begins at rest.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_steps) * dt
    T = t[-1] if num_steps > 1 else 1.0
    w = rng.uniform(0.5, 1.5, num_joints) * 2 * np.pi / T  # ~0.5-1.5 periods
    p = rng.uniform(-np.pi, np.pi, num_joints)
    a = amplitude * rng.uniform(0.5, 1.0, num_joints)
    q0 = np.array([0.0, -np.pi / 3, np.pi / 3, -np.pi / 4, np.pi / 4, 0.0])[:num_joints]

    ramp_T = min(0.5, T / 4)
    s = np.clip(t / ramp_T, 0, 1)
    ramp = s**3 * (10 - 15 * s + 6 * s * s)  # quintic smoothstep
    dramp = np.where(s < 1, (30 * s**2 - 60 * s**3 + 30 * s**4) / ramp_T, 0.0)

    q = np.zeros((num_steps, num_joints))
    qd = np.zeros((num_steps, num_joints))
    for j in range(num_joints):
        base = np.sin(w[j] * t + p[j]) - np.sin(p[j])
        dbase = w[j] * np.cos(w[j] * t + p[j])
        q[:, j] = q0[j] + a[j] * ramp * base
        qd[:, j] = a[j] * (dramp * base + ramp * dbase)
    return np.concatenate([q, qd], axis=1)
