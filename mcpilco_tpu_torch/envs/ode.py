"""ODE dynamics and fixed-step RK4 integration on tensors, as in
``mcpilco_tpu/envs/ode.py``:

- :func:`pendulum` (m=1, l=1, b=0.1, g=9.81, I=ml^2/3; u = joint torque);
- :func:`cartpole` (m1=m2=0.5, l=0.5, b=0.1, g=9.81; state [x, xd, theta,
  thd]; u = cart force; pole-down stable equilibrium at theta=0);
- :func:`furuta` (a two-link Furuta pendulum, Quanser-like parameters; state
  [theta_h, theta_v, dtheta_h, dtheta_v]; u = arm torque) and
  :func:`furuta_qube` (the same driven by a DC-motor voltage with back-EMF);
- :func:`integrate` runs one control interval as a Python loop of RK4
  sub-steps with a zero-order-hold input.
"""

from __future__ import annotations

from typing import Callable

import torch


def pendulum(x: torch.Tensor, t, u: torch.Tensor) -> torch.Tensor:
    """Pendulum: state [theta, theta_dot], torque input."""
    theta, theta_dot = x[..., 0], x[..., 1]
    m, l, b, g = 1.0, 1.0, 0.1, 9.81
    inertia = m * l * l / 3.0
    acc = (u[..., 0] - b * theta_dot - 0.5 * m * l * g * torch.sin(theta)) / inertia
    return torch.stack([theta_dot, acc], dim=-1)


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


def furuta(x: torch.Tensor, t, u: torch.Tensor) -> torch.Tensor:
    """Furuta pendulum: state [theta_h, theta_v, dtheta_h, dtheta_v], torque
    on the horizontal arm (the Cazzolato & Prime 2011 two-link model)."""
    th_v, dth_h, dth_v = x[..., 1], x[..., 2], x[..., 3]
    m_p, L_a, L_p = 0.024, 0.085, 0.129
    J_a, J_p = 0.57e-4, 0.33e-4
    b_a, b_p, g = 1e-4, 5e-5, 9.81
    l_p = L_p / 2.0
    J_p_tot = J_p + m_p * l_p * l_p
    J_a_tot = J_a + m_p * L_a * L_a
    sv, cv = torch.sin(th_v), torch.cos(th_v)
    tau = u[..., 0]
    # mass matrix, then coriolis / gravity / friction
    m11 = J_a_tot + J_p_tot * sv * sv
    m12 = m_p * l_p * L_a * cv
    m22 = J_p_tot
    c1 = J_p_tot * 2.0 * sv * cv * dth_h * dth_v - m_p * l_p * L_a * sv * dth_v**2 + b_a * dth_h
    c2 = -J_p_tot * sv * cv * dth_h**2 + m_p * g * l_p * sv + b_p * dth_v
    det = m11 * m22 - m12 * m12
    rhs1, rhs2 = tau - c1, -c2
    ddth_h = (m22 * rhs1 - m12 * rhs2) / det
    ddth_v = (-m12 * rhs1 + m11 * rhs2) / det
    return torch.stack([dth_h, dth_v, ddth_h, ddth_v], dim=-1)


def furuta_qube(x: torch.Tensor, t, u: torch.Tensor) -> torch.Tensor:
    """Furuta pendulum driven by a DC-motor VOLTAGE (QUBE-Servo-2-like):
    tau = kt (V - km dtheta_h) / Rm; the back-EMF bounds the arm speed."""
    kt, km, Rm = 0.042, 0.042, 8.4
    tau = kt * (u[..., 0] - km * x[..., 2]) / Rm
    return furuta(x, t, tau[..., None])


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


REGISTRY = {
    "pendulum": pendulum,
    "cartpole": cartpole,
    "furuta": furuta,
    "furuta_qube": furuta_qube,
}
