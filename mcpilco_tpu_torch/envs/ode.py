"""ODE dynamics of the cart-pole and fixed-step RK4 integration on tensors.

- :func:`cartpole` (m1=m2=0.5, l=0.5, b=0.1, g=9.81; state [x, xd, theta,
  thd]; u = cart force; pole-down stable equilibrium at theta=0), as in
  ``mcpilco_tpu/envs/ode.py``.
- :func:`integrate` runs one control interval as a Python loop of RK4
  sub-steps with a zero-order-hold input.
"""

from __future__ import annotations

from typing import Callable

import torch


def cartpole(x: torch.Tensor, t, u: torch.Tensor) -> torch.Tensor:
    """Cart-pole: state [x, x_dot, theta, theta_dot], force input."""
    pos_dot, theta, theta_dot = x[..., 1], x[..., 2], x[..., 3]
    m1, m2, l, b, g = 0.5, 0.5, 0.5, 0.1, 9.81
    s, c = torch.sin(theta), torch.cos(theta)
    f = u[..., 0]
    den = 4.0 * (m1 + m2) - 3.0 * m2 * c * c
    x_acc = (2.0 * m2 * l * theta_dot**2 * s + 3.0 * m2 * g * s * c + 4.0 * f - 4.0 * b * pos_dot) / den
    th_acc = (
        -3.0 * m2 * l * theta_dot**2 * s * c - 6.0 * (m1 + m2) * g * s - 6.0 * (f - b * pos_dot) * c
    ) / (l * den)
    return torch.stack([pos_dot, x_acc, theta_dot, th_acc], dim=-1)


def rk4_step(ode: Callable, x: torch.Tensor, t, h, u: torch.Tensor) -> torch.Tensor:
    k1 = ode(x, t, u)
    k2 = ode(x + 0.5 * h * k1, t + 0.5 * h, u)
    k3 = ode(x + 0.5 * h * k2, t + 0.5 * h, u)
    k4 = ode(x + h * k3, t + h, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate(ode: Callable, x0: torch.Tensor, u: torch.Tensor, dt: float, substeps: int = 20,
              t0=0.0) -> torch.Tensor:
    """Integrate one control interval [t0, t0+dt] with zero-order-hold input."""
    h = dt / substeps
    x = x0
    for i in range(substeps):
        x = rk4_step(ode, x, t0 + i * h, h, u)
    return x


REGISTRY = {"cartpole": cartpole}
