"""The numbers that decide ``correct``.  Two calls of the window's own kind
are judged against the float64 plain reference (``reference/common.py``):
the warm-up call, ``check_steps`` optimizer steps from the handed-in
policy, and the window's last call, which ran ``steps_per_call`` steps in
replayed chunks, from the policy the calls before it left.

- ``loss_gap`` (warm-up call): the gap between the port's first cost and
  the reference's, over the reference's: the whole forward pass from the
  handed-in data, hyperparameters and policy (the posterior, every rollout
  step's prediction, sampling and integration, the policy, the cost)
  through the closed loop.  Later steps' costs are not compared: Adam's
  first step moves every parameter by the learning rate times the sign of
  its gradient, and where a gradient is nought to rounding its sign is the
  rounding's, so float32 alone moves them by percents (``PERF.md``).
- ``cost_gap`` (both calls): the call's last cost against the reference's
  cost of the call's own last rollout (the stage cost of each of its
  states, the mean over its particles, summed over time): no closed loop
  between them, so only float32 summation parts them.
- ``predict_gap`` (both calls): the last rollout, taken state by state:
  for each of its states and inputs the reference's next state (the GP's
  prediction, the draw with the normals of the call's last step, the
  integration), against the port's next state; per state dimension the
  root mean square of the gap over that of the reference's one-step change,
  the worst dimension.  The closed loop carries no rounding from step to
  step here.  The draws are those of the step the call says it ended at,
  so a call that ran fewer steps than it counts reads here too.
- ``steps_short`` (both calls): the steps the call was asked for less the
  steps it says it did.  Within a call's length no configuration's
  convergence monitor may stop a lane (its ``min_step`` lies beyond), so
  this is exactly 0.
- ``grad_gap`` (warm-up call): each step's gradient as the optimizer got
  it, read from its Adam moments after the step (m_s = b1 m_(s-1) +
  (1 - b1) g_s), against the reference's gradient along the port's own
  rollout of that step (``reference.common.forced_grad``), both clipped to
  the configuration's norm: per leaf the norm of their difference over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger, the worst leaf and step.  Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out.  The cost and the
  rollouts do not see a gradient taken over fewer particles than the cost;
  this does.  It is the difference and not the gap of the two norms: a
  gradient over half of the particles can have the whole one's norm to a
  percent and another direction (``PERF.md``).
- ``unmoved`` (warm-up call): 1 if the last rollout's inputs are the
  starting policy's at its states (within ``UNMOVED``): the call's first
  step left the parameters as they were; else 0.

The worst lane counts.  A reading that is not finite is infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import common as ref

LEAF_FLOOR = 1e-3
# the last rollout's inputs within this of the starting policy's: unmoved
UNMOVED = 1e-4

NUMBERS = ("loss_gap", "cost_gap", "predict_gap", "steps_short", "grad_gap", "unmoved")
# the numbers the window's last call is judged by too
LAST = ("cost_gap", "predict_gap", "steps_short")


def _rms(t):
    return float(torch.sqrt(torch.mean(t * t)))


def _finite(call: dict) -> bool:
    done = int(call["steps_done"])
    return (all(math.isfinite(float(c)) for c in call["costs"][:done])
            and bool(torch.isfinite(torch.as_tensor(call["states"])).all())
            and bool(torch.isfinite(torch.as_tensor(call["inputs"])).all()))


def grad_leaves(mod, cfg, heads, call: dict, key: tuple) -> list:
    """Per step of the call (``call["trace"]``: the port's gradient, the
    params it was taken at and the rollout's states) and per leaf: (the
    reference's gradient norm along the port's rollout, the port's norm,
    the norm of their difference, the median leaf's reference norm)."""
    out, dev = [], heads[0].X.device
    for s, st in enumerate(call["trace"]):
        states = torch.as_tensor(st["states"], device=dev)
        want = ref.forced_grad(mod, cfg, heads, st["params"], states, tuple(key) + (s, 0),
                               torch.float64)
        norms = {k: float(torch.linalg.vector_norm(g)) for k, g in want.items()}
        med = float(np.median(list(norms.values())))
        for k, g in want.items():
            got = torch.as_tensor(st["grad"][k], device=dev).to(torch.float64)
            out.append((norms[k], float(torch.linalg.vector_norm(got)),
                        float(torch.linalg.vector_norm(got - g)), med))
    return out


def grad_gap(leaves: list) -> float:
    """The worst leaf's distance between the port's gradient and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves under ``LEAF_FLOOR`` of the median
    are left out."""
    return max([diff / max(want, med) for want, _, diff, med in leaves
                if want >= LEAF_FLOOR * med], default=0.0)


def call_numbers(mod, cfg, heads, call: dict, key: tuple, asked: int) -> dict:
    """``cost_gap``, ``predict_gap`` and ``steps_short`` of one lane's call
    (``call``: its costs, steps done, and last rollout's states and
    inputs; ``key``: the call's key)."""
    dt = torch.float64
    done = int(call["steps_done"])
    if done < 1:
        return dict(cost_gap=math.inf, predict_gap=math.inf, steps_short=float(asked))
    S = torch.as_tensor(call["states"], device=heads[0].X.device).to(dt)
    U = torch.as_tensor(call["inputs"], device=S.device).to(dt)
    nxt = ref.one_step(mod, cfg, heads, S, U, tuple(key) + (done - 1, 0), dt)
    err, move = S[1:] - nxt, nxt - S[:-1]
    own = float(ref.expected_cost(mod, S)[0])
    return {"cost_gap": abs(float(call["costs"][done - 1]) - own) / abs(own),
            "predict_gap": max(_rms(err[..., d]) / _rms(move[..., d])
                               for d in range(S.shape[-1])),
            "steps_short": float(asked - done)}


def lane_numbers(mod, cfg, judge: dict, warm: dict, before: dict, last: dict = None,
                 keys=NUMBERS) -> dict:
    """One lane's numbers among ``keys``.  ``judge``: the reference's
    posterior ``heads``, first cost ``cost0`` and the calls' keys (``key``,
    ``last_key``); ``warm``, ``last``: the lane's warm-up call and the
    window's last call (costs, steps done, last rollout, and for the warm-up
    the per-step ``trace``); ``before``: the lane's parameters at the
    warm-up's start.  ``grad_gap``, the dearest, is worked out only where
    ``keys`` holds it."""
    calls = [warm] + ([last] if last is not None else [])
    if not all(_finite(c) for c in calls):
        return dict.fromkeys(keys, math.inf)
    heads, asked = judge["heads"], judge["asked"]
    out = call_numbers(mod, cfg, heads, warm, judge["key"], asked[0])
    if last is not None:
        more = call_numbers(mod, cfg, heads, last, judge["last_key"], asked[1])
        out = {k: max(out[k], more[k]) for k in LAST}
    c0 = judge["cost0"]
    S = torch.as_tensor(warm["states"], device=heads[0].X.device).to(torch.float64)
    at = tuple(judge["key"]) + (int(warm["steps_done"]) - 1, 0)
    u0 = ref.policy_at(mod, cfg, before, S, at, torch.float64)
    U = torch.as_tensor(warm["inputs"], device=S.device).to(torch.float64)
    out.update(loss_gap=abs(float(warm["costs"][0]) - c0) / abs(c0),
               unmoved=1.0 if _rms(U - u0) <= UNMOVED * _rms(u0) else 0.0)
    if "grad_gap" in keys:
        out["grad_gap"] = grad_gap(grad_leaves(mod, cfg, heads, warm, judge["key"]))
    return {k: out[k] for k in keys}


def worst(per_lane) -> dict:
    return {k: max(n[k] for n in per_lane) for k in per_lane[0]}
