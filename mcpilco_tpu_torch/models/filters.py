"""Discrete low-pass filters of the 4PMS measurement chain
(``mcpilco_tpu/models/filters.py``).

- :func:`butter1` / :func:`butter2`: closed-form Butterworth coefficients
  (numpy; equal to ``scipy.signal.butter(1|2, wn)``).
- :func:`iir_step`: one differentiable step of a first-order IIR, the online
  velocity filter; :func:`pms_measure`: one step of the whole measurement
  chain, shared by the 4PMS plant and every 4PMS rollout step.
- :func:`lfilter` / :func:`filtfilt`: causal and zero-phase filtering of a
  tensor along dim 0 with scipy's defaults (odd extension, padlen =
  3 * ntaps, steady-state initial conditions); the offline estimator of
  ``envs/plants.py`` runs them on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import consts


def butter1(wn: float) -> Tuple[np.ndarray, np.ndarray]:
    """First-order Butterworth low-pass, cutoff ``wn`` in Nyquist units."""
    w = np.tan(np.pi * wn / 2.0)
    a0 = 1.0 + w
    return np.array([w / a0, w / a0]), np.array([1.0, (w - 1.0) / a0])


def butter2(wn: float) -> Tuple[np.ndarray, np.ndarray]:
    """Second-order Butterworth low-pass, cutoff ``wn`` in Nyquist units."""
    w = np.tan(np.pi * wn / 2.0)
    s2 = np.sqrt(2.0)
    a0 = 1.0 + s2 * w + w * w
    b = (w * w / a0) * np.array([1.0, 2.0, 1.0])
    a = np.array([1.0, 2.0 * (w * w - 1.0) / a0, (1.0 - s2 * w + w * w) / a0])
    return b, a


def iir_step(b, a, x_t, x_tm1, y_tm1):
    """One step of a first-order IIR: y_t = (b0 x_t + b1 x_{t-1} - a1 y_{t-1}) / a0."""
    return (b[0] * x_t + b[1] * x_tm1 - a[1] * y_tm1) / a[0]


def pms_measure(b, a, s, noisy_pos, noisy_prev, meas_vel_prev, pos, vel, dt):
    """One step of the 4PMS measurement chain, for the plant and inside the
    rollout: positions read as ``noisy_pos``, velocities by the causal
    difference of the noisy positions, low-passed by one :func:`iir_step`.

    ``s`` [..., ds] is the true state; ``noisy_prev`` the previous raw
    measurement (noisy positions, and raw differences in the velocity
    slots); ``meas_vel_prev`` the previous filtered velocities; ``pos`` and
    ``vel`` the position and velocity indices (sequences of ints).  Returns
    (meas, noisy, meas_vel): what the policy sees, the raw measurement, and
    the filtered velocities.
    """
    pos, vel = (consts.index(i, s.device) for i in (pos, vel))
    noisy_vel = (noisy_pos - noisy_prev[..., pos]) / dt
    meas_vel = iir_step(b, a, noisy_vel, noisy_prev[..., vel], meas_vel_prev)
    meas, noisy = s.clone(), s.clone()
    meas[..., pos] = noisy_pos
    meas[..., vel] = meas_vel
    noisy[..., pos] = noisy_pos
    noisy[..., vel] = noisy_vel
    return meas, noisy, meas_vel


def _taps(b, a):
    b, a = np.asarray(b, float), np.asarray(a, float)
    n = max(len(a), len(b))
    return np.pad(b, (0, n - len(b))), np.pad(a, (0, n - len(a)))


def lfilter(b, a, x: torch.Tensor, zi: torch.Tensor = None) -> torch.Tensor:
    """Causal IIR filtering along dim 0 (direct form II transposed), as
    ``scipy.signal.lfilter``; ``zi`` [ntaps-1, *x.shape[1:]]."""
    b, a = _taps(b, a)
    n = len(b)
    if zi is None:
        zi = x.new_zeros((n - 1,) + tuple(x.shape[1:]))
    z = list(zi.unbind(0))
    out = []
    for xt in x.unbind(0):
        yt = float(b[0]) * xt + z[0]
        z = [float(b[i + 1]) * xt + (z[i + 1] if i + 1 < n - 1 else 0.0) - float(a[i + 1]) * yt
             for i in range(n - 1)]
        out.append(yt)
    return torch.stack(out)


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state initial conditions for a unit-step input
    (``scipy.signal.lfilter_zi``)."""
    b, a = _taps(b, a)
    n = len(b)
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    return np.linalg.solve(np.eye(n - 1) - A, b[1:] - a[1:] * b[0])


def filtfilt(b, a, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward filtering along dim 0, as
    ``scipy.signal.filtfilt`` with its defaults."""
    padlen = 3 * max(len(np.asarray(a)), len(np.asarray(b)))
    if x.shape[0] <= padlen:
        raise ValueError(f"input length {x.shape[0]} must exceed padlen {padlen}")
    head = 2.0 * x[0] - x[1 : padlen + 1].flip(0)
    tail = 2.0 * x[-1] - x[-padlen - 1 : -1].flip(0)
    ext = torch.cat([head, x, tail], dim=0)
    zi = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype, device=x.device)
    zi = zi.reshape((-1,) + (1,) * (x.dim() - 1))
    y = lfilter(b, a, ext, zi * ext[0])
    y = lfilter(b, a, y.flip(0), zi * y[-1]).flip(0)
    return y[padlen:-padlen]
