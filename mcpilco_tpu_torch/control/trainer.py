"""Policy optimization: BPTT through particle rollouts, Adam, and the
convergence monitor, in a host loop.

Each iteration does one rollout, one backward pass and one Adam update on
the device for L lanes at once, and reads the L costs back to the host once,
where the control logic of ``mcpilco_tpu/control/trainer.py`` runs in plain
Python, per lane:

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

A lane is one optimization: its parameters are one slice of a leading lane
axis, it has its own key, monitor, NaN retries and re-inits, and once done
its state is frozen while the others go on (the vmapped while-loop's rule).
The lanes are the ``num_restarts`` policy inits of one optimization (which
share one posterior) or the seeds of ``parallel.multiseed.SeedFarm`` (each
with its own); one restart is one lane.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.costs import CostBase
from ..utils import prng
from .rollout import InitialStateDistribution, RolloutEngine, RolloutNoise, stack_lanes


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
    # each restart's winner metric ([num_restarts]: its best in-model cost
    # under keep_best, else its last) and the winning lane, when
    # num_restarts > 1; every other field is the winner's
    restart_costs: Optional[np.ndarray] = None
    restart_winner: Optional[int] = None


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


@dataclasses.dataclass
class _Lane:
    """Host state of one lane of :meth:`PolicyOptimizer.optimize_lanes`."""

    mon: ConvergenceMonitor
    cost_prev: float
    states: torch.Tensor
    inputs: torch.Tensor
    step: int = 0
    retry: int = 0
    reinit_count: int = 0
    adam_count: int = 0
    done: bool = False
    best_cost: float = math.inf
    costs: list = dataclasses.field(default_factory=list)
    # per logged step, the loop iteration whose std it logged (-1: a re-init)
    std_from: list = dataclasses.field(default_factory=list)


def _per_lane(t, like):
    """A per-lane tensor [L] broadcast against a leaf [L, ...]."""
    return t.reshape((-1,) + (1,) * (like.dim() - 1))


@dataclasses.dataclass(frozen=True)
class PolicyOptimizer:
    """Static config of the policy-gradient optimizer.

    ``num_restarts`` > 1 optimizes R policy inits against one posterior and
    keeps the winner: lane 0 starts from the incoming params on the
    single-restart key schedule, lanes 1..R-1 from ``policy.reinit`` draws,
    and each lane folds its id into its keys.  ``restart_vmap`` runs the R
    lanes in one lane-batched loop; False runs them one after another, with
    the same draws and the same winner rule.
    """

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
    num_restarts: int = 1
    restart_vmap: bool = True
    # The JAX package cuts its compiled optimization loop into chunks of
    # host dispatch of this many steps (adapted towards chunk_target_s
    # seconds, at most chunk_iter_slack x the chunk's steps of loop
    # iterations), which changes no number.  This host loop drives every
    # step already: the fields are taken so that scenarios build the same
    # optimizer in both packages, and change nothing here.
    chunk_steps: int = 500
    chunk_target_s: float = 15.0
    chunk_iter_slack: float = 2.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8

    def _rollout_cost(self, params, gp_params, posterior, keys, p_drop, trial_index,
                      noise: Optional[RolloutNoise] = None):
        """(cost, (std, states, inputs)) of one rollout of L lanes from fresh
        particles: ``keys`` a list of L keys, ``params`` [L, ...], ``p_drop``
        one rate or one per lane; costs [L] and states [T, L, P, ds].
        """
        device = posterior.x_tr.device
        s0 = torch.stack([
            self.init_dist.sample(prng.stream(k, prng.STREAM_INIT_PARTICLES),
                                  self.num_particles, device,
                                  eps=None if noise is None else noise.init[i])
            for i, k in enumerate(keys)
        ])
        res = self.engine.simulate(keys, params, gp_params, posterior, s0, self.horizon,
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
        """Frozen leaves' gradients zeroed, then each lane's gradient clipped
        to a global norm of ``grad_clip_norm``."""
        grads = {k: g if mask[k] else torch.zeros_like(g) for k, g in grads.items()}
        if self.grad_clip_norm is not None and self.grad_clip_norm > 0:
            gn = torch.sqrt(sum(torch.sum((g * g).flatten(1), dim=1) for g in grads.values()))
            scale = torch.clamp(self.grad_clip_norm / (gn + 1e-12), max=1.0)
            grads = {k: g * _per_lane(scale, g) for k, g in grads.items()}
        return grads

    def optimize(self, key, policy_params: dict, gp_params, posterior, num_opt_steps, lr0,
                 p_dropout0, trial_index=0, noise_fn=None) -> OptResult:
        """Run up to ``num_opt_steps`` (<= max_opt_steps) Adam steps of each
        of ``num_restarts`` lanes and return the winner's result.

        ``noise_fn(step_key)``, when given, supplies each rollout's
        :class:`RolloutNoise` in place of the generators (tests use it).
        """
        R = max(int(self.num_restarts), 1)
        inits = [policy_params]
        if R > 1:
            # lanes 1..R-1: fresh draws from a stream of their own
            rkeys = prng.split(prng.fold(key, prng.STREAM_RESTARTS), R - 1)
            inits += [self.engine.policy.reinit(policy_params, k) for k in rkeys]
        stack = lambda ps: {k: torch.stack([p[k] for p in ps]) for k in policy_params}
        run = lambda ps, rids: self.optimize_lanes(
            [key] * len(rids), stack(ps), gp_params, posterior, num_opt_steps, lr0, p_dropout0,
            trial_index, rids=rids, noise_fn=noise_fn)
        if self.restart_vmap:
            results, metric = run(inits, list(range(R)))
        else:
            lanes = [run([p], [r]) for r, p in enumerate(inits)]
            results = [res[0] for res, _ in lanes]
            metric = np.concatenate([m for _, m in lanes])
        if R == 1:
            return results[0]
        winner = int(np.argmin(np.where(np.isfinite(metric), metric, np.inf)))
        return results[winner]._replace(restart_costs=metric, restart_winner=winner)

    def optimize_lanes(self, keys: List, policy_params: dict, gp_params, posterior,
                       num_opt_steps, lr0, p_dropout0, trial_index=0, rids=None,
                       noise_fn=None):
        """Optimize L lanes in one lane-batched loop: ``policy_params`` [L, ...],
        one key per lane, ``rids`` the lanes' restart ids (folded into their
        keys; 0 by default).  ``gp_params`` and ``posterior`` are shared or
        have the lane axis in front of every leaf.

        Each iteration runs one rollout and one backward pass for all lanes
        and reads the [L] costs back once; a lane that is done stays frozen
        (its rollout still runs and is discarded) until every lane is done.
        Returns (one :class:`OptResult` per lane, each lane's winner metric
        [L]: its best cost under ``keep_best``, else its last).
        """
        num_steps = int(min(int(num_opt_steps), self.max_opt_steps))
        L = len(keys)
        rids = [0] * L if rids is None else list(rids)
        policy = self.engine.policy
        mask = policy.param_mask(policy_params)

        def rollout(params, ks, rates):
            noise = None if noise_fn is None else stack_lanes([noise_fn(k) for k in ks])
            return self._rollout_cost(params, gp_params, posterior, ks, rates, trial_index, noise)

        params = {k: v.detach() for k, v in policy_params.items()}
        dev = next(iter(params.values())).device
        # probe rollout to initialize the convergence monitors (dropout IS
        # applied there); forward only
        with torch.no_grad():
            c0, (_, st0, in0) = rollout(params, [prng.fold(k, 0x9999) for k in keys],
                                        float(p_dropout0))
        lanes = [_Lane(mon=self._monitor(lr0, p_dropout0), cost_prev=0.0 if math.isnan(c) else c,
                       states=st0[:, i], inputs=in0[:, i])
                 for i, c in enumerate(c0.tolist())]
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v = {k: torch.zeros_like(t) for k, t in params.items()}
        best = dict(params)
        stds = []  # per iteration, the lanes' std [L] (read back at the end)
        while True:
            live = [not ln.done and ln.step < num_steps for ln in lanes]
            if not any(live):
                break
            # the retry counter and the restart id ride high bits so that the
            # healthy path of lane 0 keeps the plain (step, reinit) schedule
            kts = [prng.fold(keys[i], ln.step,
                             ln.reinit_count + ln.retry * (1 << 20) + rids[i] * (1 << 26))
                   for i, ln in enumerate(lanes)]
            leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
            cost, (std, st, inp) = rollout(leaves, kts, [ln.mon.p_drop for ln in lanes])
            grads = dict(zip(leaves, torch.autograd.grad(cost.sum(), list(leaves.values()))))
            costs = cost.detach().cpu().tolist()  # the iteration's one host read
            stds.append(std.detach())
            it = len(stds) - 1
            adv, reinit = [False] * L, {}
            for i, (ln, c) in enumerate(zip(lanes, costs)):
                if not live[i]:
                    continue
                if not math.isnan(c):
                    adv[i] = True
                elif ln.retry < self.max_nan_retries:
                    ln.retry += 1
                else:
                    # give up: log cost_prev for this step and re-initialize
                    ln.costs.append(ln.cost_prev)
                    ln.std_from.append(-1)
                    ln.step += 1
                    ln.retry = 0
                    reinit[i] = prng.stream(kts[i], prng.STREAM_POLICY_INIT)
                    ln.mon = self._monitor(lr0, p_dropout0)
                    ln.cost_prev = 0.0
                    ln.reinit_count += 1
                    ln.adam_count = 0
            if any(adv):
                params, m, v, best = self._advance(lanes, adv, costs, params, grads, mask, m, v,
                                                   best, dev)
                for i, ln in enumerate(lanes):
                    if adv[i]:
                        ln.std_from.append(it)
                        ln.states, ln.inputs = st[:, i].detach(), inp[:, i].detach()
            if reinit:
                idx = list(reinit)
                fresh = policy.reinit({k: t[idx] for k, t in params.items()}, list(reinit.values()))
                params = {k: t.index_copy(0, torch.tensor(idx, device=dev), fresh[k])
                          for k, t in params.items()}
                m, v = ({k: t.index_fill(0, torch.tensor(idx, device=dev), 0.0)
                         for k, t in state.items()} for state in (m, v))
        return self._lane_results(lanes, params, best, stds)

    def _advance(self, lanes, adv, costs, params, grads, mask, m, v, best, dev):
        """One Adam step of the lanes in ``adv``, their monitors, and the
        best-cost snapshot; the other lanes' tensors are left as they are."""
        b1, b2, eps = self.adam_b1, self.adam_b2, self.adam_eps
        counts = [ln.adam_count + 1 for ln in lanes]
        # the step's lr, bias corrections and lane masks in one copy
        host = torch.tensor([[ln.mon.lr for ln in lanes], [1.0 - b1**n for n in counts],
                             [1.0 - b2**n for n in counts]], dtype=torch.float32)
        lr, bc1, bc2 = host.to(dev)
        grads = self._masked_grads(grads, mask)
        m_new = {k: b1 * m[k] + (1 - b1) * g for k, g in grads.items()}
        v_new = {k: b2 * v[k] + (1 - b2) * g * g for k, g in grads.items()}
        new = {k: p - _per_lane(lr, p) * (m_new[k] / _per_lane(bc1, p))
               / (torch.sqrt(v_new[k] / _per_lane(bc2, p)) + eps) for k, p in params.items()}
        improved, reset = [False] * len(lanes), [False] * len(lanes)
        for i, ln in enumerate(lanes):
            if not adv[i]:
                continue
            c = costs[i]
            reduce_lr, exit_now = ln.mon.update(ln.step, c - ln.cost_prev)
            reset[i] = reduce_lr
            ln.adam_count = 0 if reduce_lr else counts[i]
            if c < ln.best_cost:
                ln.best_cost = c
                improved[i] = True
            ln.cost_prev = c
            ln.costs.append(c)
            ln.retry = 0
            ln.step += 1
            ln.done = exit_now

        def where(flags, a, b):
            if all(flags):
                return a
            if not any(flags):
                return b
            sel = torch.tensor(flags, device=dev)
            return {k: torch.where(_per_lane(sel, a[k]), a[k], b[k]) for k in a}

        # a plateau's lr reduction restarts that lane's Adam moments
        zeros = {k: torch.zeros_like(t) for k, t in m.items()} if any(reset) else None
        moved = [a and not r for a, r in zip(adv, reset)]
        m, v = where(reset, zeros, where(moved, m_new, m)), where(reset, zeros, where(moved, v_new, v))
        return where(adv, new, params), m, v, where(improved, params, best)

    def _lane_results(self, lanes, params, best, stds):
        stds = torch.stack(stds).cpu() if stds else None  # [iterations, L]
        results, metric = [], []
        for i, ln in enumerate(lanes):
            steps = ln.step
            cost_history = torch.zeros(self.max_opt_steps, dtype=torch.float32)
            std_history = torch.zeros(self.max_opt_steps, dtype=torch.float32)
            if steps:
                cost_history[:steps] = torch.tensor(ln.costs)
                std_history[:steps] = torch.tensor(
                    [0.0 if it < 0 else float(stds[it, i]) for it in ln.std_from])
            final = best if self.keep_best and math.isfinite(ln.best_cost) else params
            results.append(OptResult(
                policy_params={k: t[i].detach() for k, t in final.items()},
                cost_history=cost_history,
                std_history=std_history,
                steps_done=steps,
                states=ln.states,
                inputs=ln.inputs,
                reinit_count=ln.reinit_count,
                final_lr=ln.mon.lr,
                final_p_dropout=ln.mon.p_drop,
            ))
            metric.append(ln.best_cost if self.keep_best else ln.cost_prev)
        return results, np.asarray(metric, dtype=np.float64)
