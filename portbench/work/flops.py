"""Frozen work counts: the analytic FLOPs of one optimizer lane-step per
configuration, and K1's and K2's bytes and FLOPs per launch, with the
peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W).

``se_gram`` is the count of the JAX package's ``bench.analytic_step_flops``
(SE gram by direct differences, the mean and the factored variance
contractions, the policy; x3 for BPTT), which the flagship's SE+P(2) and
SE paths share.  A configuration's own count lives in its reference
module (``reference/<name>.py``), under the name its ``flops`` key gives,
and may build on ``se_gram``.  ``k1_work``,
``k2_work`` and ``gen_work`` are the port's ``ops/fused_predict`` counts
as of this benchmark: every input read once, every output written once.
"""

import importlib

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def se_gram(P, horizon, M, D, num_heads, num_basis, feat_dim, du, **_):
    gram = num_heads * P * M * (3 * D + 10)
    mean = num_heads * 2 * P * M
    var = num_heads * (2 * P * M * M + 2 * P * M)
    policy = P * num_basis * (3 * feat_dim + 8) + 2 * P * num_basis * du
    per_scan_step = gram + mean + var + policy + 60 * P
    return 3 * horizon * per_scan_step


def k1_work(L, P, M, use_poly, G, D):
    inputs = G * D + G + G * (D + 1) + 2 * G * D + P * D + M * D + G * M + G * M * M + G * M
    outputs = 2 * G * P + G * P * M
    gen = 4 * D + 4 + (6 * D + 3 if use_poly else 0)
    return 4 * L * (inputs + outputs), L * G * P * M * (2 * M + 4 + gen)


def gen_work(L, P, M, use_poly, G, D):
    inputs = G * D + G + G * (D + 1) + 2 * G * D + P * D + M * D + 2 * G * M
    gen = 4 * D + 4 + (6 * D + 3 if use_poly else 0)
    return 4 * L * (inputs + G * P * M + G * P), L * G * P * M * (gen + 2)


def k2_work(L, P, M, use_poly, G, D):
    inputs = (G * D + G + G * (D + 1) + 2 * G * D + P * D + M * D + G * M + G * M * M + G * M
              + G * P * M + 2 * G * P)
    epi = 7 * D + 8 + (8 * D if use_poly else 0)
    return 4 * L * (inputs + P * D), L * G * P * M * (2 * M + epi)


def bound_s(work) -> float:
    """The least time one H100 could take for (bytes, flops)."""
    return max(work[0] / PEAK_HBM_BYTES, work[1] / PEAK_FP32_FLOPS)


def lane_step_flops(cfg: dict, M: int) -> float:
    """The configuration's analytic FLOPs of one lane-step at M points: the
    function its ``flops`` key names in its reference module."""
    pol = cfg["policy"]
    count = getattr(importlib.import_module(f"portbench.reference.{cfg['reference']}"),
                    cfg["flops"])
    return count(
        P=cfg["num_particles"], horizon=cfg["horizon"], M=M, D=cfg["gp_input_dim"],
        num_heads=cfg["num_heads"], num_basis=pol["num_basis"], feat_dim=len(pol["center_low"]),
        du=1, se_dims=cfg.get("se_dims"))
