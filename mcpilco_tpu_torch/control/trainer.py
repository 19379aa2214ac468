"""Policy optimization: BPTT through particle rollouts, Adam, and the
convergence monitor.

Each iteration of the loop has two parts.  The device body runs one
rollout, one backward pass and the Adam candidate step for L lanes at once,
and reads nothing but tensors that stay in place for the whole call: the
policy leaves, the Adam moments, the iteration's learning rate, bias
corrections and dropout rates, and its random numbers.  On CUDA the body
is captured once per call as a CUDA graph (``torch.cuda.CUDAGraph``) and
replayed every iteration, the counterpart of the JAX package's compiled
loop (``mcpilco_tpu/control/trainer.py``, ``_optimize_chunk``); elsewhere,
or with ``graph=False``, the same body runs uncaptured.  The host part
draws the iteration's random numbers into those tensors, reads the L costs
back once, and runs the control logic in plain Python, per lane:

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
- the best-cost snapshot (``keep_best``);
- the lane selection: the body's candidate params and moments are written
  into the leaves and moments, in place, on the lanes that advanced.

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
import os
import time
import traceback
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.costs import CostBase
from ..ops import fused_predict as fp
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
    step: int = 0
    retry: int = 0
    reinit_count: int = 0
    adam_count: int = 0
    done: bool = False
    best_cost: float = math.inf
    costs: list = dataclasses.field(default_factory=list)
    # per logged step, its rollout's particle std (0 for a re-init)
    stds: list = dataclasses.field(default_factory=list)


def _per_lane(t, like):
    """A per-lane tensor [L] broadcast against a leaf [L, ...]."""
    return t.reshape((-1,) + (1,) * (like.dim() - 1))


# Uncaptured iterations of a call before its body is captured.  The first
# run of the body loads every kernel module and library handle it touches
# and makes its constants (``utils/consts``), none of which may happen
# during a capture; each further one would cost a whole uncaptured
# iteration per call.
GRAPH_WARMUP = 1

# Iterations of the optimization loop by how the body ran: uncaptured, the
# capture (and its first replay), or a replay of the graph; "uncaptured_s"
# and "replays_s" hold the host seconds of those iterations, from the host
# part's start to the lane selection's end, "captures_s" those of the
# captures themselves (capture and instantiation).
graph_counts = {"uncaptured": 0, "captures": 0, "replays": 0, "uncaptured_s": 0.0,
                "captures_s": 0.0, "replays_s": 0.0}


def reset_graph_counts() -> None:
    graph_counts.update(uncaptured=0, captures=0, replays=0, uncaptured_s=0.0, captures_s=0.0,
                        replays_s=0.0)


# one side stream per device for every call's warm-up: PyTorch keeps a
# cuBLAS workspace per stream for the life of the process, so a new stream
# per call would hold more device memory with every call
_side_streams = {}


def _side_stream(device) -> torch.cuda.Stream:
    device = torch.device(device)
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


# the lane axis of each RolloutNoise field
_NOISE_LANE_AXIS = RolloutNoise(state=1, keep=1, init=0, meas=1, init_idx=0)


@dataclasses.dataclass
class _Static:
    """The tensors the device body reads: written in place by the host part
    before each run of the body, never reallocated during a call."""

    leaves: dict  # the policy parameters [L, ...], requires_grad
    m: dict  # Adam's moments
    v: dict
    hyper: torch.Tensor  # [4, L]: lr, 1 - b1^n, 1 - b2^n, dropout rate
    host: torch.Tensor  # its staging copy on the host (pinned on CUDA)
    dropout: bool  # False: the policy applies no dropout in this call
    noise: Optional[RolloutNoise] = None  # allocated at the first put_noise

    @classmethod
    def new(cls, params: dict, dropout: bool) -> "_Static":
        t = next(iter(params.values()))
        L, dev = t.shape[0], t.device
        return cls(leaves={k: v.clone().requires_grad_(True) for k, v in params.items()},
                   m={k: torch.zeros_like(v) for k, v in params.items()},
                   v={k: torch.zeros_like(v) for k, v in params.items()},
                   hyper=torch.zeros((4, L), dtype=torch.float32, device=dev),
                   host=torch.zeros((4, L), dtype=torch.float32, pin_memory=dev.type == "cuda"),
                   dropout=dropout)

    def set_hyper(self, rows) -> None:
        self.host.numpy()[:] = rows
        # the previous iteration's host read has waited for the last copy
        self.hyper.copy_(self.host, non_blocking=True)

    def put_noise(self, i: int, noise: RolloutNoise) -> None:
        """Lane ``i``'s random numbers into the lane-batched buffers; a lane
        without dropout keeps every feature."""
        L = self.hyper.shape[1]
        if self.noise is None:
            self.noise = RolloutNoise(*(
                None if t is None else t.new_empty(t.shape[:ax] + (L,) + t.shape[ax:])
                for t, ax in zip(noise, _NOISE_LANE_AXIS)))
        for buf, t, ax in zip(self.noise, noise, _NOISE_LANE_AXIS):
            if buf is not None:
                slot = buf[:, i] if ax else buf[i]
                if t is None:
                    slot.fill_(True)
                else:
                    slot.copy_(t)


class _BodyOut(NamedTuple):
    cost_std: torch.Tensor  # [2, L]: the costs and the particle stds
    states: torch.Tensor  # [T, L, P, ds]
    inputs: torch.Tensor  # [T, L, P, du]
    params: dict  # Adam's candidate step of every lane
    m: dict
    v: dict


def _failed_op(err: BaseException) -> str:
    """Where the first exception of ``err``'s chain was raised: the
    innermost frame of this package, else the innermost frame."""
    while err.__context__ is not None:
        err = err.__context__
    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if f"{os.sep}mcpilco_tpu_torch{os.sep}" in f.filename]
    f = (ours or frames)[-1]
    return f"{f.filename}:{f.lineno} ({f.line}): {type(err).__name__}: {err}"


class _DeviceStep:
    """Runs the device body of every iteration of one call: uncaptured, or
    with ``capture`` the first ``GRAPH_WARMUP`` times on a side stream, then
    captured once as a CUDA graph that every later call replays.  It holds
    the body, and with it everything the graph reads, until :meth:`close`."""

    def __init__(self, body, capture: bool, device):
        self.body, self.capture = body, capture
        self.graph = self.out = self.launches = None
        self.warm = 0
        self.side = _side_stream(device) if capture else None
        self.ran = None  # how the last call ran: a key of graph_counts

    def __call__(self) -> _BodyOut:
        self.ran = "replays" if self.graph is not None else "uncaptured"
        if self.graph is None and self.capture and self.warm == GRAPH_WARMUP:
            self._capture()
            self.ran = "captures"
        graph_counts[self.ran] += 1
        if self.graph is not None:
            self.graph.replay()
            self.launches.replay()
            return self.out
        if not self.capture:
            return self.body()
        self.warm += 1
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            out = self.body()
        main.wait_stream(self.side)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with fp.CapturedLaunches() as launches, torch.cuda.graph(graph):
                out = self.body()
        except RuntimeError as err:
            raise RuntimeError("the CUDA-graph capture of the optimizer step failed at "
                               + _failed_op(err)) from err
        graph_counts["captures_s"] += time.perf_counter() - t0
        self.graph, self.out, self.launches = graph, out, launches

    def close(self) -> None:
        """Free the graph and the memory pool its capture allocated from."""
        if self.graph is None:
            return
        self.graph = self.out = self.body = None
        # a freed graph's pool stays reserved until the cache is emptied
        torch.cuda.empty_cache()


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
    # The JAX package runs its compiled optimization loop in chunks of host
    # dispatch of this many steps (adapted towards chunk_target_s seconds,
    # at most chunk_iter_slack x the chunk's steps of loop iterations),
    # which changes no number.  This loop reads the costs back after every
    # iteration (one graph replay on CUDA): the fields are taken so that
    # scenarios build the same optimizer in both packages, and change
    # nothing here.
    chunk_steps: int = 500
    chunk_target_s: float = 15.0
    chunk_iter_slack: float = 2.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8

    def _rollout_cost(self, params, gp_params, posterior, keys, p_drop, trial_index,
                      noise: Optional[RolloutNoise] = None):
        """(cost, (std, states, inputs)) of one rollout of L lanes from fresh
        particles: ``params`` [L, ...]; ``noise`` the lanes' random numbers,
        the initial particles' included, or None to draw them from ``keys``
        (a list of L keys); ``p_drop`` one rate, one per lane, or a tensor
        [L]; costs [L] and states [T, L, P, ds].
        """
        device = posterior.x_tr.device
        if noise is None:
            noise = self.engine.draw_noise(keys, self.num_particles, self.horizon, p_drop, device,
                                           init_dist=self.init_dist)
        s0 = self.init_dist.sample(None, self.num_particles, device, eps=noise.init,
                                   idx=noise.init_idx)
        res = self.engine.simulate(None, params, gp_params, posterior, s0, self.horizon,
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
                 p_dropout0, trial_index=0, noise_fn=None, graph: Optional[bool] = None
                 ) -> OptResult:
        """Run up to ``num_opt_steps`` (<= max_opt_steps) Adam steps of each
        of ``num_restarts`` lanes and return the winner's result.

        ``noise_fn(step_key)``, when given, supplies each rollout's
        :class:`RolloutNoise` in place of the generators (tests use it).
        ``graph``: see :meth:`optimize_lanes`.
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
            trial_index, rids=rids, noise_fn=noise_fn, graph=graph)
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
                       noise_fn=None, graph: Optional[bool] = None):
        """Optimize L lanes in one lane-batched loop: ``policy_params`` [L, ...],
        one key per lane, ``rids`` the lanes' restart ids (folded into their
        keys; 0 by default).  ``gp_params`` and ``posterior`` are shared or
        have the lane axis in front of every leaf.

        Each iteration runs the device body (:meth:`_body`: one rollout, one
        backward pass and the Adam candidate for all lanes) and reads the [L]
        costs back once; a lane that is done stays frozen (its rollout still
        runs and is discarded) until every lane is done.  ``graph`` None
        captures the body as a CUDA graph when the policy is on a CUDA
        device (after ``GRAPH_WARMUP`` uncaptured iterations) and replays it
        for every later iteration; False runs it uncaptured; a capture that
        fails raises.
        Returns (one :class:`OptResult` per lane, each lane's winner metric
        [L]: its best cost under ``keep_best``, else its last).
        """
        num_steps = int(min(int(num_opt_steps), self.max_opt_steps))
        L = len(keys)
        rids = [0] * L if rids is None else list(rids)
        policy = self.engine.policy
        mask = policy.param_mask(policy_params)
        params = {k: v.detach() for k, v in policy_params.items()}
        dev = next(iter(params.values())).device
        if graph is None:
            graph = dev.type == "cuda"
        elif graph and dev.type != "cuda":
            raise ValueError(f"graph=True captures the step on a CUDA device; the policy is on "
                             f"{dev}")
        P, T, init = self.num_particles, self.horizon, self.init_dist

        def lane_noise(k, rate):
            """One lane's random numbers from its step key, on the host side
            of the iteration."""
            if noise_fn is None:
                return self.engine.draw_noise(k, P, T, rate, dev, init_dist=init)
            n = noise_fn(k)
            if n.init is None or (init.kind == "multi_gauss" and n.init_idx is None):
                eps, idx = init.draw(prng.stream(k, prng.STREAM_INIT_PARTICLES), P, dev)
                n = n._replace(init=eps if n.init is None else n.init,
                               init_idx=idx if n.init_idx is None else n.init_idx)
            return n

        # probe rollout to initialize the convergence monitors (dropout IS
        # applied there); forward only
        probe = stack_lanes([lane_noise(prng.fold(k, 0x9999), float(p_dropout0)) for k in keys])
        with torch.no_grad():
            c0, (_, st0, in0) = self._rollout_cost(params, gp_params, posterior, None,
                                                   float(p_dropout0), trial_index, probe)
        lanes = [_Lane(mon=self._monitor(lr0, p_dropout0), cost_prev=0.0 if math.isnan(c) else c)
                 for c in c0.tolist()]
        buf = _Static.new(params, dropout=float(p_dropout0) > 0)
        best = {k: t.clone() for k, t in params.items()}
        last = [st0, in0]  # each lane's rollout of its last healthy step
        b1, b2 = self.adam_b1, self.adam_b2
        step = _DeviceStep(lambda: self._body(buf, gp_params, posterior, trial_index, mask), graph,
                           dev)
        out = None
        try:
            while True:
                live = [not ln.done and ln.step < num_steps for ln in lanes]
                if not any(live):
                    break
                t_iter = time.perf_counter()
                # the retry counter and the restart id ride high bits so that
                # the healthy path of lane 0 keeps the plain (step, reinit)
                # schedule
                kts = [prng.fold(keys[i], ln.step,
                                 ln.reinit_count + ln.retry * (1 << 20) + rids[i] * (1 << 26))
                       for i, ln in enumerate(lanes)]
                for i, (k, ln) in enumerate(zip(kts, lanes)):
                    buf.put_noise(i, lane_noise(k, ln.mon.p_drop))
                buf.set_hyper([[ln.mon.lr for ln in lanes],
                               [1.0 - b1 ** (ln.adam_count + 1) for ln in lanes],
                               [1.0 - b2 ** (ln.adam_count + 1) for ln in lanes],
                               [ln.mon.p_drop for ln in lanes]])
                out = step()
                costs, stds = out.cost_std.cpu().tolist()  # the iteration's one host read
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
                        ln.stds.append(0.0)
                        ln.step += 1
                        ln.retry = 0
                        reinit[i] = prng.stream(kts[i], prng.STREAM_POLICY_INIT)
                        ln.mon = self._monitor(lr0, p_dropout0)
                        ln.cost_prev = 0.0
                        ln.reinit_count += 1
                        ln.adam_count = 0
                if any(adv):
                    last = self._advance(lanes, adv, costs, stds, buf, out, best, last)
                if reinit:
                    self._reinit(buf, reinit)
                if step.ran != "captures":
                    graph_counts[step.ran + "_s"] += time.perf_counter() - t_iter
        finally:
            out = None
            step.close()
        return self._lane_results(lanes, buf.leaves, best, last)

    def _body(self, buf: _Static, gp_params, posterior, trial_index, mask) -> _BodyOut:
        """The device part of one iteration, for every lane: the rollout from
        ``buf.noise`` at ``buf.leaves``, its policy gradient (masked and
        clipped) and Adam's candidate step from ``buf.m``, ``buf.v`` and
        ``buf.hyper``.  It reads no tensor but ``buf``'s, the posterior and
        the GP parameters, draws no random number, makes no tensor from
        host data and reads nothing back: on CUDA it is what the graph
        captures."""
        rate = buf.hyper[3] if buf.dropout else 0.0
        cost, (std, states, inputs) = self._rollout_cost(buf.leaves, gp_params, posterior, None,
                                                         rate, trial_index, buf.noise)
        names = list(buf.leaves)
        grads = self._masked_grads(
            dict(zip(names, torch.autograd.grad(cost.sum(), [buf.leaves[k] for k in names]))),
            mask)
        b1, b2, eps = self.adam_b1, self.adam_b2, self.adam_eps
        lr, bc1, bc2 = buf.hyper[0], buf.hyper[1], buf.hyper[2]
        with torch.no_grad():
            m = {k: b1 * buf.m[k] + (1 - b1) * g for k, g in grads.items()}
            v = {k: b2 * buf.v[k] + (1 - b2) * g * g for k, g in grads.items()}
            new = {k: p - _per_lane(lr, p) * (m[k] / _per_lane(bc1, p))
                   / (torch.sqrt(v[k] / _per_lane(bc2, p)) + eps) for k, p in buf.leaves.items()}
        return _BodyOut(cost_std=torch.stack([cost.detach(), std]), states=states.detach(),
                        inputs=inputs.detach(), params=new, m=m, v=v)

    def _advance(self, lanes, adv, costs, stds, buf: _Static, out: _BodyOut, best, last):
        """The monitors of the lanes in ``adv``; then, on those lanes, the
        best-cost snapshot, Adam's step and moments written into ``buf`` in
        place, and their rollout kept.  Returns the kept rollouts."""
        improved, reset = [False] * len(lanes), [False] * len(lanes)
        for i, ln in enumerate(lanes):
            if not adv[i]:
                continue
            c = costs[i]
            reduce_lr, exit_now = ln.mon.update(ln.step, c - ln.cost_prev)
            reset[i] = reduce_lr
            ln.adam_count = 0 if reduce_lr else ln.adam_count + 1
            if c < ln.best_cost:
                ln.best_cost = c
                improved[i] = True
            ln.cost_prev = c
            ln.costs.append(c)
            ln.stds.append(stds[i])
            ln.retry = 0
            ln.step += 1
            ln.done = exit_now
        # a plateau's lr reduction restarts that lane's Adam moments
        moved = [a and not r for a, r in zip(adv, reset)]
        with torch.no_grad():
            _write_lanes(improved, best, buf.leaves)  # the params that scored the cost
            _write_lanes(adv, buf.leaves, out.params)
            for state, new in ((buf.m, out.m), (buf.v, out.v)):
                _write_lanes(moved, state, new)
                if any(reset):
                    _write_lanes(reset, state, {k: torch.zeros_like(t) for k, t in state.items()})
        # copies: the graph's outputs are overwritten by the next replay
        return [_take_lanes(adv, new, old) for new, old in zip((out.states, out.inputs), last)]

    def _reinit(self, buf: _Static, reinit: dict) -> None:
        """Re-initialize the lanes of ``reinit`` (lane -> key) in place:
        fresh policy draws, zero Adam moments."""
        ix = torch.tensor(list(reinit), device=buf.hyper.device)
        with torch.no_grad():
            fresh = self.engine.policy.reinit({k: t[ix] for k, t in buf.leaves.items()},
                                              list(reinit.values()))
            for k, t in buf.leaves.items():
                t.index_copy_(0, ix, fresh[k])
            for state in (buf.m, buf.v):
                for t in state.values():
                    t.index_fill_(0, ix, 0.0)

    def _lane_results(self, lanes, params, best, last):
        results, metric = [], []
        for i, ln in enumerate(lanes):
            steps = ln.step
            cost_history = torch.zeros(self.max_opt_steps, dtype=torch.float32)
            std_history = torch.zeros(self.max_opt_steps, dtype=torch.float32)
            if steps:
                cost_history[:steps] = torch.tensor(ln.costs)
                std_history[:steps] = torch.tensor(ln.stds)
            final = best if self.keep_best and math.isfinite(ln.best_cost) else params
            results.append(OptResult(
                policy_params={k: t[i].detach() for k, t in final.items()},
                cost_history=cost_history,
                std_history=std_history,
                steps_done=steps,
                states=last[0][:, i],
                inputs=last[1][:, i],
                reinit_count=ln.reinit_count,
                final_lr=ln.mon.lr,
                final_p_dropout=ln.mon.p_drop,
            ))
            metric.append(ln.best_cost if self.keep_best else ln.cost_prev)
        return results, np.asarray(metric, dtype=np.float64)


def _lane_mask(sel, like, axis=0):
    """A bool tensor [L] that broadcasts against ``like``, whose lane axis
    is ``axis``."""
    return sel.reshape((1,) * axis + (-1,) + (1,) * (like.dim() - axis - 1))


def _write_lanes(flags, dst: dict, src: dict) -> None:
    """``dst[k] <- src[k]`` in place, on the lanes in ``flags``."""
    if not any(flags):
        return
    sel = None if all(flags) else torch.tensor(flags, device=next(iter(dst.values())).device)
    for k, d in dst.items():
        d.copy_(src[k] if sel is None else torch.where(_lane_mask(sel, d), src[k], d))


def _take_lanes(flags, new, old):
    """Per lane (axis 1), ``new`` where ``flags`` else ``old``: a tensor of
    its own, never ``new``."""
    if all(flags):
        return new.clone()
    return torch.where(_lane_mask(torch.tensor(flags, device=new.device), new, axis=1), new, old)
