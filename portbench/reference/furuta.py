"""The Furuta pendulum's own functions for the plain reference: state
[theta_h, theta_v, dtheta_h, dtheta_v]; the GP predicts the two velocity
changes from the state, the input and seven physics features of the
forward dynamics, with SE over the first 5 inputs plus a linear kernel
(phi Sigma phi') over the 7 features; the policy sees [dtheta_h,
dtheta_v, cos theta_h, cos theta_v, sin theta_h, sin theta_v] scaled by
(15, 30, 1, 1, 1, 1); the stage cost is
1 - exp(-((|theta_v| - pi) / 2)^2 - (theta_h / 4)^2).

Also the configuration's plant, the ODE its training trials are integrated
by (``furuta_qube``), and its FLOP count per optimizer lane-step
(``se_linear_gram``)."""

import math

import numpy as np
import torch

from portbench.work.flops import se_gram

VEL, POS = (2, 3), (0, 1)
SCALE = (15.0, 30.0, 1.0, 1.0, 1.0, 1.0)


def gp_inputs(s, u):
    th_v, dh, dv = s[..., 1:2], s[..., 2:3], s[..., 3:4]
    sv, s2v = torch.sin(th_v), torch.sin(2.0 * th_v)
    return torch.cat([s, u, sv * dv**2, dh * dv * s2v, dh, dh**2 * s2v, dv, sv,
                      u * torch.cos(th_v)], dim=-1)


def policy_input(s):
    ang = s[..., 0:2]
    z = torch.cat([s[..., 2:4], torch.cos(ang), torch.sin(ang)], dim=-1)
    return z / torch.as_tensor(SCALE, dtype=s.dtype, device=s.device)


def stage_cost(states):
    d = ((torch.abs(states[..., 1]) - math.pi) / 2.0) ** 2 + (states[..., 0] / 4.0) ** 2
    return 1.0 - torch.exp(-d)


def kernel(kp, X1, X2):
    se, lin = kp
    w = torch.exp(-2.0 * se["log_lengthscales"])
    d = sum(w[i] * (X1[:, None, i] - X2[None, :, i]) ** 2 for i in range(5))
    phi1, phi2 = X1[:, 5:], X2[:, 5:]
    return (torch.exp(se["log_lambda"]) * torch.exp(-d)
            + (phi1 * torch.exp(2.0 * lin["log_sigma_diag"])) @ phi2.T)


def kdiag(kp, X):
    se, lin = kp
    phi = X[:, 5:]
    return (torch.exp(se["log_lambda"]) * torch.ones_like(X[:, 0])
            + torch.sum(phi * phi * torch.exp(2.0 * lin["log_sigma_diag"]), dim=1))


def prior_mean(kp, X):
    return kp[0]["mean"] * torch.ones_like(X[:, 0])


def furuta_qube(x, u):
    """The plant: state [theta_h, theta_v, dtheta_h, dtheta_v], driven by a
    DC motor's voltage (kt = km = 0.042, Rm = 8.4) through the Cazzolato &
    Prime two-link model; numpy."""
    th_v, dth_h, dth_v = x[..., 1], x[..., 2], x[..., 3]
    tau = 0.042 * (u[..., 0] - 0.042 * dth_h) / 8.4
    m_p, L_a, L_p, J_a, J_p = 0.024, 0.085, 0.129, 0.57e-4, 0.33e-4
    b_a, b_p, g = 1e-4, 5e-5, 9.81
    l_p = L_p / 2.0
    J_p_tot, J_a_tot = J_p + m_p * l_p * l_p, J_a + m_p * L_a * L_a
    sv, cv = np.sin(th_v), np.cos(th_v)
    m11, m12, m22 = J_a_tot + J_p_tot * sv * sv, m_p * l_p * L_a * cv, J_p_tot
    c1 = J_p_tot * 2.0 * sv * cv * dth_h * dth_v - m_p * l_p * L_a * sv * dth_v**2 + b_a * dth_h
    c2 = -J_p_tot * sv * cv * dth_h**2 + m_p * g * l_p * sv + b_p * dth_v
    det = m11 * m22 - m12 * m12
    r1, r2 = tau - c1, -c2
    return np.stack([dth_h, dth_v, (m22 * r1 - m12 * r2) / det, (-m12 * r1 + m11 * r2) / det],
                    axis=-1)


def se_linear_gram(P, horizon, M, D, num_heads, num_basis, feat_dim, du, se_dims, **_):
    """The FLOPs of one lane-step with a Sum(SE over ``se_dims`` inputs,
    Linear over the D - se_dims others) gram: ``se_gram`` over the SE's
    dims, plus per (particle, point, head) 2 FLOPs per linear feature and
    the sum of the two members (x3 for BPTT, per rollout step)."""
    se = se_gram(P, horizon, M, se_dims, num_heads, num_basis, feat_dim, du)
    linear = num_heads * P * M * (2 * (D - se_dims) + 1)
    return se + 3 * horizon * linear
