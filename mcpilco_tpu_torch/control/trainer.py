"""Policy optimization: BPTT through particle rollouts, Adam, and the
convergence monitor, in a host loop.

Each step does one rollout, one backward pass and one Adam update on the
device, and reads the cost back to the host once (``.item()``), where the
control logic of ``mcpilco_tpu/control/trainer.py`` runs in plain Python:

- manual Adam (torch.optim.Adam semantics) with a trainable-leaf mask and
  global-norm gradient clipping at ``grad_clip_norm``;
- the exponential-smoothing convergence monitor and plateau logic
  (:class:`ConvergenceMonitor`):

      ES1 <- a*ES1 + (1-a)(c_t - c_{t-1})
      ES2 <- a*(ES2 + (1-a)(c_t - c_{t-1} - ES1_prev)^2)
      dcr <- a*dcr + (1-a) ES1/sqrt(ES2)

  a plateau (|dcr| < thr for ``num_min_diff_cost`` consecutive steps after
  ``min_step``) halves lr (>= lr_min), halves thr (>= thr_floor), reduces
  dropout and resets the Adam moments; at lr_min the loop stops;
- the NaN guard: a NaN cost is re-sampled with fresh noise up to
  ``max_nan_retries`` times without advancing the step, then the policy and
  optimizer are re-initialized;
- the best-cost snapshot (``keep_best``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..models.costs import CostBase
from ..utils import prng
from .rollout import InitialStateDistribution, RolloutEngine, RolloutNoise


class AdamState(NamedTuple):
    m: dict
    v: dict
    count: int


def adam_init(params: dict) -> AdamState:
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(m=zeros, v={k: torch.zeros_like(v) for k, v in params.items()}, count=0)


@torch.no_grad()
def adam_update(grads: dict, state: AdamState, params: dict, lr, b1=0.9, b2=0.999, eps=1e-8):
    count = state.count + 1
    m = {k: b1 * state.m[k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state.v[k] + (1 - b2) * g * g for k, g in grads.items()}
    bc1, bc2 = 1.0 - b1**count, 1.0 - b2**count
    new = {k: p - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps) for k, p in params.items()}
    return new, AdamState(m=m, v=v, count=count)


_F32_TINY = 1.1754943508222875e-38  # float32 tiny: ES2's guard (mcpilco_tpu/control/trainer.py:670)


class OptResult(NamedTuple):
    policy_params: dict
    cost_history: torch.Tensor  # [max_opt_steps]; entries past steps_done are 0
    std_history: torch.Tensor
    steps_done: int
    states: torch.Tensor  # last rollout [T, P, ds]
    inputs: torch.Tensor  # last rollout [T, P, du]
    reinit_count: int
    final_lr: float
    final_p_dropout: float


@dataclasses.dataclass
class ConvergenceMonitor:
    """The ES convergence monitor and plateau schedule of one optimization
    (MC_PILCO.py:507-567 of the reference)."""

    alpha: float
    num_min_diff_cost: int
    min_step: float
    lr_reduction_ratio: float
    lr_min: float
    p_drop_reduction: float
    thr_floor: float
    lr: float
    p_drop: float
    thr: float
    gate_step: float = dataclasses.field(init=False)
    consec: int = 0
    es1: float = 0.0
    es2: float = 0.0
    dcr: float = 0.0

    def __post_init__(self):
        self.gate_step = self.min_step

    def update(self, step: int, dc: float):
        """Feed the cost change of step ``step``; returns (reduce_lr, exit)."""
        a = self.alpha
        es1 = a * self.es1 + (1 - a) * dc
        self.es2 = a * (self.es2 + (1 - a) * (dc - self.es1) ** 2)
        self.es1 = es1
        self.dcr = a * self.dcr + (1 - a) * (es1 / math.sqrt(self.es2 + _F32_TINY))
        self.consec = self.consec + 1 if abs(self.dcr) < self.thr else 0
        gate = step > self.gate_step and self.consec >= self.num_min_diff_cost
        can_reduce = self.lr > self.lr_min * (1 + 1e-6)
        if gate and can_reduce:
            self.lr = max(self.lr * self.lr_reduction_ratio, self.lr_min)
            self.thr = max(self.thr * 0.5, self.thr_floor)
            self.gate_step = step + self.num_min_diff_cost
            self.p_drop = max(self.p_drop - self.p_drop_reduction, 0.0)
            self.consec = 0
        return gate and can_reduce, gate and not can_reduce


@dataclasses.dataclass(frozen=True)
class PolicyOptimizer:
    """Static config of the policy-gradient optimizer (single restart)."""

    engine: RolloutEngine
    cost: CostBase
    init_dist: InitialStateDistribution
    num_particles: int
    horizon: int
    max_opt_steps: int
    alpha_diff_cost: float = 0.99
    min_diff_cost: float = 0.1
    num_min_diff_cost: int = 200
    min_step: float = float("inf")
    lr_reduction_ratio: float = 0.5
    lr_min: float = 0.001
    p_drop_reduction: float = 0.0
    thr_floor: float = 0.01
    grad_clip_norm: float = 100.0
    keep_best: bool = True
    max_nan_retries: int = 10
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8

    def _rollout_cost(self, params, gp_params, posterior, key, p_drop, trial_index,
                      noise: Optional[RolloutNoise] = None):
        """(cost, (std, states, inputs)) of one rollout from fresh particles."""
        device = posterior.x_tr.device
        s0 = self.init_dist.sample(
            prng.stream(key, prng.STREAM_INIT_PARTICLES), self.num_particles, device,
            eps=None if noise is None else noise.init,
        )
        res = self.engine.simulate(key, params, gp_params, posterior, s0, self.horizon,
                                   p_dropout=p_drop, noise=noise)
        c, s = self.cost(res.states, res.inputs, trial_index)
        return c, (s, res.states, res.inputs)

    def _monitor(self, lr0, p_dropout0) -> ConvergenceMonitor:
        return ConvergenceMonitor(
            alpha=self.alpha_diff_cost, num_min_diff_cost=self.num_min_diff_cost,
            min_step=self.min_step, lr_reduction_ratio=self.lr_reduction_ratio,
            lr_min=self.lr_min, p_drop_reduction=self.p_drop_reduction,
            thr_floor=self.thr_floor, lr=float(lr0), p_drop=float(p_dropout0),
            thr=self.min_diff_cost,
        )

    def _masked_grads(self, grads: dict, mask: dict) -> dict:
        grads = {k: g if mask[k] else torch.zeros_like(g) for k, g in grads.items()}
        if self.grad_clip_norm is not None and self.grad_clip_norm > 0:
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(self.grad_clip_norm / (gn + 1e-12), max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        return grads

    def optimize(self, key, policy_params: dict, gp_params, posterior, num_opt_steps, lr0,
                 p_dropout0, trial_index=0, noise_fn=None) -> OptResult:
        """Run up to ``num_opt_steps`` (<= max_opt_steps) Adam steps.

        ``noise_fn(step_key)``, when given, supplies each rollout's
        :class:`RolloutNoise` in place of the generators (tests use it).
        """
        num_steps = int(min(int(num_opt_steps), self.max_opt_steps))
        policy = self.engine.policy
        mask = policy.param_mask(policy_params)

        def rollout(params, k, p_drop):
            noise = None if noise_fn is None else noise_fn(k)
            return self._rollout_cost(params, gp_params, posterior, k, p_drop, trial_index,
                                      noise)

        params = {k: v.detach() for k, v in policy_params.items()}
        # probe rollout to initialize the convergence monitor (dropout IS
        # applied there); forward only
        with torch.no_grad():
            c0, (_, states, inputs) = rollout(params, prng.fold(key, 0x9999), float(p_dropout0))
        c0 = c0.item()
        cost_prev = 0.0 if math.isnan(c0) else c0
        mon = self._monitor(lr0, p_dropout0)
        adam = adam_init(params)
        best_cost, best_params = math.inf, params
        cost_hist, std_hist = [], []
        step = reinit_count = retry = 0
        done = False
        while step < num_steps and not done:
            # the retry counter rides a high bit so that the healthy path
            # keeps the plain (step, reinit) key schedule
            kt = prng.fold(key, step, reinit_count + retry * (1 << 20))
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            cost, (std, st, inp) = rollout(leaves, kt, mon.p_drop)
            grads = dict(zip(leaves, torch.autograd.grad(cost, list(leaves.values()))))
            c = cost.item()
            if math.isnan(c):
                if retry < self.max_nan_retries:
                    retry += 1
                    continue
                # give up: log cost_prev for this step and re-initialize
                cost_hist.append(cost_prev)
                std_hist.append(torch.zeros_like(std))
                step += 1
                retry = 0
                params = policy.reinit(params, prng.stream(kt, prng.STREAM_POLICY_INIT))
                adam = adam_init(params)
                mon = self._monitor(lr0, p_dropout0)
                cost_prev = 0.0
                reinit_count += 1
                continue
            new_params, new_adam = adam_update(
                self._masked_grads(grads, mask), adam, params, mon.lr,
                self.adam_b1, self.adam_b2, self.adam_eps,
            )
            reduce_lr, exit_now = mon.update(step, c - cost_prev)
            adam = adam_init(new_params) if reduce_lr else new_adam
            if c < best_cost:
                best_cost, best_params = c, params
            params = new_params
            cost_prev = c
            cost_hist.append(c)
            std_hist.append(std.detach())
            states, inputs = st.detach(), inp.detach()
            retry = 0
            step += 1
            done = exit_now

        cost_history = torch.zeros(self.max_opt_steps, dtype=torch.float32)
        std_history = torch.zeros(self.max_opt_steps, dtype=torch.float32)
        if step:
            cost_history[:step] = torch.tensor(cost_hist)
            std_history[:step] = torch.stack(std_hist).float().cpu()
        final = best_params if self.keep_best and math.isfinite(best_cost) else params
        return OptResult(
            policy_params={k: v.detach() for k, v in final.items()},
            cost_history=cost_history,
            std_history=std_history,
            steps_done=step,
            states=states,
            inputs=inputs,
            reinit_count=reinit_count,
            final_lr=mon.lr,
            final_p_dropout=mon.p_drop,
        )
