"""The flagship cart-pole's own functions for the plain reference: state
[x, x_dot, theta, theta_dot]; the GP predicts the two velocity changes from
[x, x_dot, theta_dot, sin theta, cos theta, u] with an SE + polynomial(2)
kernel: SE over the 6 inputs, plus (phi Sigma_1 phi') with phi = [x, 1],
plus the product of two (x Sigma_d x') terms; the policy sees [x, x_dot,
theta_dot, cos theta, sin theta]; the stage cost is
1 - exp(-((|theta| - pi) / 3)^2 - x^2).

Also the configuration's plant, the ODE its training trials are integrated
by (``cartpole``), and its FLOP count per optimizer lane-step
(``se_gram``, the frozen count of ``work/flops.py``)."""

import math

import numpy as np
import torch

from portbench.work.flops import se_gram  # noqa: F401  (the configuration's ``flops``)

VEL, POS = (1, 3), (0, 2)


def gp_inputs(s, u):
    th = s[..., 2:3]
    return torch.cat([s[..., 0:2], s[..., 3:4], torch.sin(th), torch.cos(th), u], dim=-1)


def policy_input(s):
    th = s[..., 2:3]
    return torch.cat([s[..., 0:2], s[..., 3:4], torch.cos(th), torch.sin(th)], dim=-1)


def stage_cost(states):
    th, x = states[..., 2], states[..., 0]
    return 1.0 - torch.exp(-((torch.abs(th) - math.pi) / 3.0) ** 2 - x**2)


def _se(p, X1, X2):
    w = torch.exp(-2.0 * p["log_lengthscales"])
    d = sum(w[i] * (X1[:, None, i] - X2[None, :, i]) ** 2 for i in range(X1.shape[1]))
    return torch.exp(p["log_lambda"]) * torch.exp(-d)


def _lin(sig, P1, P2):
    return (P1 * torch.exp(2.0 * sig)) @ P2.T


def _one(X):
    return torch.cat([X, torch.ones_like(X[:, :1])], dim=1)


def kernel(kp, X1, X2):
    se, p1, p2 = kp
    s2 = p2["log_sigma_diag"]
    return (_se(se, X1, X2) + _lin(p1["log_sigma_diag"][0], _one(X1), _one(X2))
            + _lin(s2[0], X1, X2) * _lin(s2[1], X1, X2))


def kdiag(kp, X):
    se, p1, p2 = kp
    s2 = p2["log_sigma_diag"]
    quad = lambda sig, P: torch.sum(P * P * torch.exp(2.0 * sig), dim=1)
    return (torch.exp(se["log_lambda"]) * torch.ones_like(X[:, 0])
            + quad(p1["log_sigma_diag"][0], _one(X)) + quad(s2[0], X) * quad(s2[1], X))


def prior_mean(kp, X):
    return kp[0]["mean"] * torch.ones_like(X[:, 0])


def cartpole(x, u):
    """The plant: state [x, x_dot, theta, theta_dot], cart force (m1 = m2 =
    0.5, l = 0.5, b = 0.1, g = 9.81; theta = 0 hangs down); numpy."""
    xd, th, thd = x[..., 1], x[..., 2], x[..., 3]
    m1, m2, l, b, g = 0.5, 0.5, 0.5, 0.1, 9.81
    s, c, f = np.sin(th), np.cos(th), u[..., 0]
    den = 4.0 * (m1 + m2) - 3.0 * m2 * c * c
    x_acc = (2.0 * m2 * l * thd**2 * s + 3.0 * m2 * g * s * c + 4.0 * f - 4.0 * b * xd) / den
    th_acc = (-3.0 * m2 * l * thd**2 * s * c - 6.0 * (m1 + m2) * g * s
              - 6.0 * (f - b * xd) * c) / (l * den)
    return np.stack([xd, x_acc, thd, th_acc], axis=-1)
