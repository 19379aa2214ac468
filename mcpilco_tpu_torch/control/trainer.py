"""Policy optimization: BPTT through particle rollouts, Adam, and the
convergence monitor, K iterations per host read.

Each iteration of the loop is one run of the device body for L lanes at
once: the rollout, its masked and clipped policy gradient, the Adam
candidate step, and all of the control logic, on [L] tensors that stay in
place for the whole call (``_Static``), as the JAX package's compiled loop
(``mcpilco_tpu/control/trainer.py``, ``_optimize_chunk``) carries them:

- manual Adam (torch.optim.Adam semantics, bias corrections 1 - b^t in
  float32) with a trainable-leaf mask and global-norm gradient clipping at
  ``grad_clip_norm``;
- the exponential-smoothing convergence monitor and plateau logic
  (:meth:`PolicyOptimizer.monitor_update`, float32):

      ES1 <- a*ES1 + (1-a)(c_t - c_{t-1})
      ES2 <- a*(ES2 + (1-a)(c_t - c_{t-1} - ES1_prev)^2)
      dcr <- a*dcr + (1-a) ES1/sqrt(ES2)

  a plateau (|dcr| < thr for ``num_min_diff_cost`` consecutive steps after
  ``min_step``) halves lr (>= lr_min), halves thr (>= thr_floor), reduces
  dropout and resets the Adam moments; at lr_min the lane is done;
- the best-cost snapshot (``keep_best``), the cost and std histories, the
  last healthy rollout, and the write of the candidate params and moments
  into the leaves, on the lanes that advanced (``torch.where`` on device
  masks).

A lane whose cost is NaN halts: it stays frozen until the host reads the
lanes back.  The host then runs the NaN guard: a halted lane is re-sampled
with fresh noise (the retry counter folded into its key) up to
``max_nan_retries`` times without advancing the step, then its policy and
optimizer are re-initialized.  On CUDA the body is captured once per call
as a CUDA graph (``torch.cuda.CUDAGraph``) and replayed; elsewhere, or with
``graph=False``, the same body runs uncaptured.

The host runs K iterations per read (a chunk, the counterpart of
``_drive_chunks``): before each it draws the iteration's random numbers
into the body's buffers, on the healthy key schedule (step, step + 1, ...),
stream-ordered behind the previous iteration, so the host runs ahead of the
device; after each it copies the lanes' status to the host without waiting.
It waits for the status of the iteration ``POLL_LAG`` back before it issues
another, and ends the chunk early once every lane has stopped; at the
chunk's end it reads the status (step, done, halted) once and handles the
halted lanes.  The draws depend only on the keys, so the results are
bitwise the same for every K.

A lane is one optimization: its parameters are one slice of a leading lane
axis, it has its own key, monitor, NaN retries and re-inits, and once done
its state is frozen while the others go on (the vmapped while-loop's rule).
The lanes are the ``num_restarts`` policy inits of one optimization (which
share one posterior) or the seeds of ``parallel.multiseed.SeedFarm`` (each
with its own); one restart is one lane.

With a ``mesh`` (``parallel/mesh.py``; one process per device) each rank
rolls out its slice of the particles, drawn on the full logical shape from
the same keys: the cost pieces (``models/costs.expected_cost``) and the
policy gradient are summed over the particle axis ``"p"`` in the body,
before Adam, so every rank reads the global cost and takes the same
decisions, the same host reads and the same NaN re-samples.  On a
``("r", "p")`` mesh each rank runs its share of the restart lanes under
their global ids, and one all-gather of the lanes' metrics picks the
winner, whose result is broadcast.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.costs import CostBase
from ..ops import fused_predict as fp
from ..parallel import mesh as mesh_mod
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


class Monitor(NamedTuple):
    """The convergence monitor of L lanes, as the JAX loop carries it: [L]
    float32 tensors, the consecutive-plateau count int32."""

    lr: torch.Tensor
    p_drop: torch.Tensor
    thr: torch.Tensor
    gate_step: torch.Tensor
    consec: torch.Tensor
    es1: torch.Tensor
    es2: torch.Tensor
    dcr: torch.Tensor


def _per_lane(t, like):
    """A per-lane tensor [L] broadcast against a leaf [L, ...]."""
    return t.reshape((-1,) + (1,) * (like.dim() - 1))


def _lane_mask(sel, like, axis=0):
    """A bool tensor [L] that broadcasts against ``like``, whose lane axis
    is ``axis``."""
    return sel.reshape((1,) * axis + (-1,) + (1,) * (like.dim() - axis - 1))


# Uncaptured iterations of a call before its body is captured.  The first
# run of the body loads every kernel module and library handle it touches
# and makes its constants (``utils/consts``), none of which may happen
# during a capture; each further one would cost a whole uncaptured
# iteration per call.  They are a chunk of their own.
GRAPH_WARMUP = 1

# The host issues iteration j of a chunk only once the lanes' status after
# iteration j - POLL_LAG has reached it, and ends the chunk there if every
# lane has stopped: the host stays at most POLL_LAG iterations ahead of the
# device, and at most POLL_LAG - 1 iterations run after the last lane
# stopped.  With 2 the host issues an iteration while the previous one runs.
POLL_LAG = 2

# The loop's iterations by how the body ran: uncaptured, or as a replay of
# the graph (the replay right after the capture included), and the
# captures; "reads" the host's reads of the lanes' status (one per chunk),
# "wasted" the iterations run while no lane was live (after every lane had
# stopped, before the host saw it).  "uncaptured_s" and "replays_s" hold the
# host seconds of those iterations' chunks, from the first draw to the end
# of the read's handling, less the captures' own seconds ("captures_s":
# capture and instantiation).
graph_counts = {"uncaptured": 0, "captures": 0, "replays": 0, "reads": 0, "wasted": 0,
                "uncaptured_s": 0.0, "captures_s": 0.0, "replays_s": 0.0}


def reset_graph_counts() -> None:
    graph_counts.update({k: type(v)() for k, v in graph_counts.items()})


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
# a kept feature's uniform for a keep-mask handed in (noise_fn): below
# every keep-probability; a dropped one's: the largest float32 below 1, at
# or above every keep-probability under 1 - 2^-24
_BELOW_ONE = 1.0 - 2.0 ** -24
# the loop state of every lane, one row [L] each: float32, and int32 (the
# first _STATUS rows are what the host reads back)
_FLOATS = ("lr", "p_drop", "thr", "gate_step", "es1", "es2", "dcr", "cost_prev", "best_cost")
_INTS = ("step", "done", "halted", "idle", "consec", "adam_count")
_STATUS = 4


@dataclasses.dataclass
class _Static:
    """The tensors the device body reads and writes: written in place, never
    reallocated during a call."""

    leaves: dict  # the policy parameters [L, ...], requires_grad
    m: dict  # Adam's moments
    v: dict
    best: dict  # each lane's params of its best cost so far
    floats: torch.Tensor  # [len(_FLOATS), L]
    ints: torch.Tensor  # [len(_INTS), L] int32; "idle" counts iterations with no lane live
    hist: torch.Tensor  # [2, L, max_opt_steps]: the cost and std histories
    states: torch.Tensor  # each lane's last healthy rollout [T, L, P, ds]
    inputs: torch.Tensor
    # the dropout uniforms' buffer [T, L, P, num_basis]; None: the policy
    # applies no dropout in this call
    keep_shape: Optional[tuple]
    noise: Optional[RolloutNoise] = None  # allocated at the first put_noise

    @classmethod
    def new(cls, params: dict, states, inputs, max_opt_steps: int,
            keep_shape: Optional[tuple]) -> "_Static":
        t = next(iter(params.values()))
        L, dev = t.shape[0], t.device
        return cls(leaves={k: v.clone().requires_grad_(True) for k, v in params.items()},
                   m={k: torch.zeros_like(v) for k, v in params.items()},
                   v={k: torch.zeros_like(v) for k, v in params.items()},
                   best={k: v.clone() for k, v in params.items()},
                   floats=torch.zeros((len(_FLOATS), L), dtype=torch.float32, device=dev),
                   ints=torch.zeros((len(_INTS), L), dtype=torch.int32, device=dev),
                   hist=torch.zeros((2, L, max_opt_steps), dtype=torch.float32, device=dev),
                   states=states.clone(), inputs=inputs.clone(), keep_shape=keep_shape)

    @property
    def dropout(self) -> bool:
        return self.keep_shape is not None

    @property
    def lane(self) -> dict:
        """Each loop-state row by name: views of ``floats`` and ``ints``."""
        rows = dict(zip(_FLOATS, self.floats))
        rows.update(zip(_INTS, self.ints))
        return rows

    def put_noise(self, i: int, noise: RolloutNoise) -> None:
        """Lane ``i``'s random numbers into the lane-batched buffers; a lane
        without dropout uniforms keeps every feature."""
        L = self.floats.shape[1]
        if self.noise is None:
            self.noise = RolloutNoise(*(
                None if t is None or name == "keep" else
                t.new_empty(t.shape[:ax] + (L,) + t.shape[ax:])
                for name, t, ax in zip(RolloutNoise._fields, noise, _NOISE_LANE_AXIS)))
            if self.dropout:
                self.noise = self.noise._replace(keep=torch.zeros(
                    self.keep_shape, dtype=torch.float32, device=self.floats.device))
        for buf, t, ax in zip(self.noise, noise, _NOISE_LANE_AXIS):
            if buf is not None:
                slot = buf[:, i] if ax else buf[i]
                if t is None:
                    slot.zero_()
                else:
                    slot.copy_(t)


class _StatusReads:
    """The lanes' status rows after each iteration, copied to the host in a
    ring of ``depth`` slots: into pinned memory without waiting, with an
    event, on CUDA; a plain copy elsewhere."""

    def __init__(self, status: torch.Tensor, depth: int):
        cuda = status.is_cuda
        self.status = status
        self.host = [torch.empty(status.shape, dtype=status.dtype, pin_memory=cuda)
                     for _ in range(depth)]
        self.events = [torch.cuda.Event() if cuda else None for _ in range(depth)]

    def record(self, j: int) -> None:
        s = j % len(self.host)
        self.host[s].copy_(self.status, non_blocking=True)
        if self.events[s] is not None:
            self.events[s].record()

    def read(self, j: int) -> np.ndarray:
        """The status after iteration ``j`` (waits for it); valid until
        iteration ``j`` + depth is recorded."""
        s = j % len(self.host)
        if self.events[s] is not None:
            self.events[s].synchronize()
        return self.host[s].numpy()


class _Lanes:
    """The host's view of the lanes: their keys and restart ids, and as of
    the last read their steps, whether done, their NaN re-samples at that
    step and their re-inits."""

    def __init__(self, keys, rids):
        self.keys, self.rids = keys, rids
        L = len(keys)
        self.steps, self.done, self.retry, self.reinits = [0] * L, [False] * L, [0] * L, [0] * L

    def key(self, i: int, step: int, retry: int):
        """Lane ``i``'s key at ``step``: the retry counter and the restart id
        ride high bits so that the healthy path of lane 0 keeps the plain
        (step, reinit) schedule."""
        return prng.fold(self.keys[i], step,
                         self.reinits[i] + retry * (1 << 20) + self.rids[i] * (1 << 26))

    def take(self, status: np.ndarray, live: list, max_nan_retries: int):
        """Take in a read of the ``live`` lanes' status (after a chunk):
        a halted lane re-samples at its step, or past ``max_nan_retries``
        gives up: its step is logged and it re-initializes from the NaN
        iteration's key.  Returns (the halted lanes, the giving-up lanes ->
        their policy-init keys)."""
        halted, give_up = [], {}
        for i in live:
            s = int(status[0, i])
            r = 0 if s > self.steps[i] else self.retry[i]
            if status[2, i]:
                halted.append(i)
                if r < max_nan_retries:
                    r += 1
                else:
                    give_up[i] = prng.stream(self.key(i, s, r), prng.STREAM_POLICY_INIT)
                    self.reinits[i] += 1
                    r, s = 0, s + 1
            self.retry[i], self.steps[i], self.done[i] = r, s, bool(status[1, i])
        return halted, give_up


def _all_stopped(status: np.ndarray, num_steps: int) -> bool:
    step, done, halted = status[0], status[1], status[2]
    return bool(np.all((done != 0) | (halted != 0) | (step >= num_steps)))


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
        self.graph = self.launches = None
        self.warm = 0
        self.side = _side_stream(device) if capture else None

    @property
    def warming(self) -> bool:
        return self.capture and self.warm < GRAPH_WARMUP

    def __call__(self) -> str:
        """Run the body once; returns how, as a key of ``graph_counts``."""
        if self.graph is None and self.capture and self.warm == GRAPH_WARMUP:
            self._capture()
        if self.graph is not None:
            graph_counts["replays"] += 1
            self.graph.replay()
            self.launches.replay()
            return "replays"
        graph_counts["uncaptured"] += 1
        if not self.capture:
            self.body()
            return "uncaptured"
        self.warm += 1
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            self.body()
        main.wait_stream(self.side)
        return "uncaptured"

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with fp.CapturedLaunches() as launches, torch.cuda.graph(graph):
                self.body()
        except RuntimeError as err:
            raise RuntimeError("the CUDA-graph capture of the optimizer step failed at "
                               + _failed_op(err)) from err
        graph_counts["captures"] += 1
        graph_counts["captures_s"] += time.perf_counter() - t0
        self.graph, self.launches = graph, launches

    def close(self) -> None:
        """Free the graph and the memory pool its capture allocated from."""
        if self.graph is None:
            return
        self.graph = self.body = None
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
    # Iterations per host read, as the JAX package sizes its chunks: the
    # first chunk of a call runs chunk_steps / lanes iterations (fewer where
    # an earlier call measured that chunk_target_s seconds hold fewer), the
    # later ones what the last chunk's rate fits into chunk_target_s (the
    # seed farm sizes its first chunk by the JAX farm's rule,
    # ``multiseed.first_chunk_steps``).  No number depends on it.
    # chunk_iter_slack, which caps a chunk's NaN retries in the JAX loop, is
    # taken and has no analog here: a NaN halts its lane until the chunk's
    # read, so no retry runs inside a chunk.
    chunk_steps: int = 500
    chunk_target_s: float = 15.0
    chunk_iter_slack: float = 2.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # A ``parallel.mesh.Mesh`` with a particle axis "p": the particles shard
    # over it, the GP parameters, the posterior and the policy parameters
    # replicate, and the cost pieces and the policy gradient are summed
    # over "p" once per iteration.  With num_restarts > 1 a ("r", "p") mesh
    # (``make_restart_particle_mesh``) also shards the restart lanes.  None:
    # one device.
    mesh: Optional[object] = None

    def _particle_group(self):
        """The process group of the ranks that hold this optimization's
        other particle shards; None without a mesh."""
        return None if self.mesh is None else self.mesh.group(mesh_mod.PARTICLE_AXIS)

    def _local_particles(self) -> int:
        if self.mesh is None:
            return self.num_particles
        n = self.mesh.shape[mesh_mod.PARTICLE_AXIS]
        if self.num_particles % n:
            raise ValueError(f"num_particles={self.num_particles} does not tile the mesh's {n} "
                             "particle shards")
        return self.num_particles // n

    def _shard_noise(self, noise: RolloutNoise, lanes: bool) -> RolloutNoise:
        """This rank's particles of the random numbers of a rollout drawn on
        the full logical shape (``lanes``: a lane axis before the particles).
        One lane's particle axes are where stacked lanes put the lane axis
        (``_NOISE_LANE_AXIS``)."""
        if self.mesh is None:
            return noise
        return RolloutNoise(*(None if t is None else
                              mesh_mod.shard_particles(self.mesh, t, ax + int(lanes))
                              for t, ax in zip(noise, _NOISE_LANE_AXIS)))

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
            noise = self._shard_noise(self.engine.draw_noise(
                keys, self.num_particles, self.horizon, p_drop, device, init_dist=self.init_dist),
                lanes=True)
        s0 = self.init_dist.sample(None, self._local_particles(), device, eps=noise.init,
                                   idx=noise.init_idx)
        res = self.engine.simulate(None, params, gp_params, posterior, s0, self.horizon,
                                   p_dropout=p_drop, noise=noise)
        c, s = self.cost(res.states, res.inputs, trial_index, group=self._particle_group())
        return c, (s, res.states, res.inputs)

    def monitor_update(self, mon: Monitor, step: torch.Tensor, dc: torch.Tensor):
        """One step of the convergence monitor and plateau schedule of every
        lane (MC_PILCO.py:507-567 of the reference; the JAX loop's,
        mcpilco_tpu/control/trainer.py:663-696), in float32: ``step`` [L] the
        steps that scored the cost changes ``dc`` [L].  Returns (the new
        monitor, reduce_lr [L], exit_now [L])."""
        a = self.alpha_diff_cost
        es1 = a * mon.es1 + (1 - a) * dc
        es2 = a * (mon.es2 + (1 - a) * (dc - mon.es1) ** 2)
        dcr = a * mon.dcr + (1 - a) * (es1 / torch.sqrt(es2 + _F32_TINY))
        consec = (mon.consec + 1) * (torch.abs(dcr) < mon.thr)
        fstep = step.to(torch.float32)
        gate = (fstep > mon.gate_step) & (consec >= self.num_min_diff_cost)
        can_reduce = mon.lr > self.lr_min * (1 + 1e-6)
        reduce_lr, exit_now = gate & can_reduce, gate & ~can_reduce
        at = lambda new, old: torch.where(reduce_lr, new, old)
        return Monitor(
            lr=at(torch.clamp(mon.lr * self.lr_reduction_ratio, min=self.lr_min), mon.lr),
            p_drop=at(torch.clamp(mon.p_drop - self.p_drop_reduction, min=0.0), mon.p_drop),
            thr=at(torch.clamp(mon.thr * 0.5, min=self.thr_floor), mon.thr),
            gate_step=at(fstep + self.num_min_diff_cost, mon.gate_step),
            consec=consec * ~reduce_lr, es1=es1, es2=es2, dcr=dcr,
        ), reduce_lr, exit_now

    def _reset_monitor(self, buf: _Static, ix, lr0, p_dropout0) -> None:
        """A fresh monitor and Adam count on the lanes ``ix``."""
        lane = buf.lane
        fresh = dict(lr=lr0, p_drop=p_dropout0, thr=self.min_diff_cost, gate_step=self.min_step,
                     es1=0.0, es2=0.0, dcr=0.0, cost_prev=0.0, consec=0, adam_count=0)
        for name, value in fresh.items():
            lane[name][ix] = value

    def _masked_grads(self, grads: dict, mask: dict) -> dict:
        """Frozen leaves' gradients zeroed, then each lane's gradient clipped
        to a global norm of ``grad_clip_norm``."""
        grads = {k: g if mask[k] else torch.zeros_like(g) for k, g in grads.items()}
        if self.grad_clip_norm is not None and self.grad_clip_norm > 0:
            gn = torch.sqrt(sum(torch.sum((g * g).flatten(1), dim=1) for g in grads.values()))
            scale = torch.clamp(self.grad_clip_norm / (gn + 1e-12), max=1.0)
            grads = {k: g * _per_lane(scale, g) for k, g in grads.items()}
        return grads

    def _chunk_budget(self, lanes: int) -> int:
        """Iterations per host read at the start of a call (the JAX loop's
        ``_first_chunk_budget``): ``chunk_steps`` over the lanes, or what the
        rate an earlier call measured fits into ``chunk_target_s``."""
        budget = max(25, self.chunk_steps // max(lanes, 1))
        rate = getattr(self, "_measured_rate", None)
        if self.chunk_target_s and rate:
            budget = min(budget, max(25, int(self.chunk_target_s * rate)))
        return budget

    def optimize(self, key, policy_params: dict, gp_params, posterior, num_opt_steps, lr0,
                 p_dropout0, trial_index=0, noise_fn=None, graph: Optional[bool] = None,
                 chunk: Optional[int] = None) -> OptResult:
        """Run up to ``num_opt_steps`` (<= max_opt_steps) Adam steps of each
        of ``num_restarts`` lanes and return the winner's result.

        ``noise_fn(step_key)``, when given, supplies each rollout's
        :class:`RolloutNoise` in place of the generators (tests use it).
        ``graph``, ``chunk``: see :meth:`optimize_lanes`.
        """
        R = max(int(self.num_restarts), 1)
        lanes = self._restart_lanes(R)
        if self.mesh is not None:
            policy_params = mesh_mod.replicate(self.mesh, policy_params,
                                               self.mesh.replica_axes())
        inits = self.restart_inits(key, policy_params, R)
        stack = lambda ps: {k: torch.stack([p[k] for p in ps]) for k in policy_params}
        run = lambda ps, rids: self.optimize_lanes(
            [key] * len(rids), stack(ps), gp_params, posterior, num_opt_steps, lr0, p_dropout0,
            trial_index, rids=rids, noise_fn=noise_fn, graph=graph, chunk=chunk)
        if self.restart_vmap:
            results, metric = run([inits[r] for r in lanes], lanes)
        else:
            runs = [run([p], [r]) for r, p in enumerate(inits)]
            results = [res[0] for res, _ in runs]
            metric = np.concatenate([m for _, m in runs])
        if R == 1:
            return results[0]
        if len(lanes) < R:  # this rank's share of the lanes: the others' metrics
            metric = mesh_mod.all_gather(
                self.mesh, torch.as_tensor(metric, device=self.mesh.device),
                mesh_mod.RESTART_AXIS).cpu().numpy()
        winner = int(np.argmin(np.where(np.isfinite(metric), metric, np.inf)))
        if len(lanes) < R:
            own, i = divmod(winner, len(lanes))
            result = self._broadcast_result(results[i], own)
        else:
            result = results[winner]
        return result._replace(restart_costs=metric, restart_winner=winner)

    def restart_inits(self, key, policy_params: dict, R: int) -> list:
        """The R restart lanes' initial parameters: lane 0 starts from
        ``policy_params``, lanes 1..R-1 from fresh draws of a stream of
        their own."""
        inits = [policy_params]
        if R > 1:
            rkeys = prng.split(prng.fold(key, prng.STREAM_RESTARTS), R - 1)
            inits += [self.engine.policy.reinit(policy_params, k) for k in rkeys]
        return inits

    def _restart_lanes(self, R: int) -> list:
        """The restart lanes this rank runs: all R, or on a mesh with a
        restart axis its contiguous share (the JAX package's checks,
        ``mcpilco_tpu/control/trainer.py:303-319``)."""
        if self.mesh is None or mesh_mod.RESTART_AXIS not in self.mesh.axis_names:
            return list(range(R))
        shards = self.mesh.shape[mesh_mod.RESTART_AXIS]
        if R == 1:
            raise ValueError("mesh has a restart axis 'r' but num_restarts == 1; use a plain "
                             "particle mesh (parallel.mesh.make_mesh) instead")
        if R % shards:
            raise ValueError(f"num_restarts={R} does not tile the mesh's restart axis "
                             f"({shards} shards)")
        if not self.restart_vmap:
            raise ValueError("restart_vmap=False (sequential lanes) cannot shard a restart mesh "
                             "axis; drop the 'r' axis or keep restart_vmap")
        k = R // shards
        r0 = self.mesh.index(mesh_mod.RESTART_AXIS) * k
        return list(range(r0, r0 + k))

    def _broadcast_result(self, res: OptResult, src: int) -> OptResult:
        """The result of the rank at restart coordinate ``src`` on every rank
        of its restart group (``res``: this rank's result of the same shapes)."""
        scalars = torch.tensor([res.steps_done, res.reinit_count, res.final_lr,
                                res.final_p_dropout], dtype=torch.float64)
        tensors = (res.policy_params, res.cost_history, res.std_history, res.states, res.inputs,
                   scalars)
        params, cost, std, states, inputs, scalars = mesh_mod.broadcast(
            self.mesh, tensors, mesh_mod.RESTART_AXIS, src)
        steps, reinits, lr, p_drop = scalars.tolist()
        return OptResult(policy_params=params, cost_history=cost, std_history=std,
                         steps_done=int(steps), states=states, inputs=inputs,
                         reinit_count=int(reinits), final_lr=lr, final_p_dropout=p_drop)

    def optimize_lanes(self, keys: List, policy_params: dict, gp_params, posterior,
                       num_opt_steps, lr0, p_dropout0, trial_index=0, rids=None,
                       noise_fn=None, graph: Optional[bool] = None, chunk: Optional[int] = None,
                       first_chunk: Optional[int] = None, on_read: Optional[Callable] = None):
        """Optimize L lanes in one lane-batched loop: ``policy_params`` [L, ...],
        one key per lane, ``rids`` the lanes' restart ids (folded into their
        keys; 0 by default).  ``gp_params`` and ``posterior`` are shared or
        have the lane axis in front of every leaf.

        Each iteration runs the device body (:meth:`_body`) for all lanes; a
        lane that is done, halted or through its steps stays frozen (its
        rollout still runs and is discarded) until every lane is.  The host
        reads the lanes back once per chunk of iterations: ``chunk`` forces
        the iterations per read (1: a read after every iteration), None
        sizes them from ``chunk_steps`` and ``chunk_target_s``;
        ``first_chunk`` then sets the first chunk's budget in place of
        ``chunk_steps`` over the lanes.  ``on_read()`` is called after every
        read (the seed farm's heartbeat).  ``graph``
        None captures the body as a CUDA graph when the policy is on a CUDA
        device (after ``GRAPH_WARMUP`` uncaptured iterations, a chunk of
        their own) and replays it for every later iteration; False runs it
        uncaptured; a capture that fails raises.
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
        if chunk is not None and int(chunk) < 1:
            raise ValueError(f"chunk={chunk}: at least one iteration per host read")
        P, T, init = self.num_particles, self.horizon, self.init_dist
        P_local = self._local_particles()
        p0 = float(p_dropout0)
        if self.mesh is not None:
            gp_params, posterior = mesh_mod.replicate(self.mesh, (gp_params, posterior),
                                                      self.mesh.replica_axes())
            params = mesh_mod.replicate(self.mesh, params, mesh_mod.PARTICLE_AXIS)

        def lane_noise(k, uniforms):
            """One lane's random numbers from its step key, on the host side
            of the iteration, on the full logical shape and then this rank's
            particles; with ``uniforms`` the dropout draw as uniforms (the
            body forms the mask at the lane's rate)."""
            return self._shard_noise(full_noise(k, uniforms), lanes=False)

        def full_noise(k, uniforms):
            if noise_fn is None:
                return self.engine.draw_noise(k, P, T, p0, dev, init_dist=init,
                                              keep_uniforms=uniforms)
            n = noise_fn(k)
            if n.init is None or (init.kind == "multi_gauss" and n.init_idx is None):
                eps, idx = init.draw(prng.stream(k, prng.STREAM_INIT_PARTICLES), P, dev)
                n = n._replace(init=eps if n.init is None else n.init,
                               init_idx=idx if n.init_idx is None else n.init_idx)
            if n.keep is not None and uniforms == (n.keep.dtype == torch.bool):
                # a handed-in mask as uniforms (the mask at every positive
                # rate), or handed-in uniforms as the mask at p_dropout0
                n = n._replace(keep=torch.where(n.keep, 0.0, _BELOW_ONE).float() if uniforms
                               else n.keep < max(1.0 - p0, 1e-6))
            return n

        # probe rollout to initialize the convergence monitors (dropout IS
        # applied there); forward only
        probe = stack_lanes([lane_noise(prng.fold(k, 0x9999), False) for k in keys])
        with torch.no_grad():
            c0, (_, st0, in0) = self._rollout_cost(params, gp_params, posterior, None, p0,
                                                   trial_index, probe)
            buf = _Static.new(params, st0, in0, self.max_opt_steps,
                              (T, L, P_local, policy.num_basis) if p0 > 0 else None)
            self._reset_monitor(buf, slice(None), lr0, p0)
            buf.lane["cost_prev"].copy_(torch.where(torch.isnan(c0), 0.0, c0))
            buf.lane["best_cost"].fill_(float("inf"))
        step = _DeviceStep(lambda: self._body(buf, gp_params, posterior, trial_index, mask,
                                              num_steps), graph, dev)
        reads = _StatusReads(buf.ints[:_STATUS], POLL_LAG)
        lanes = _Lanes(keys, rids)
        if chunk is not None:
            budget = int(chunk)
        else:
            budget = int(first_chunk) if first_chunk is not None else self._chunk_budget(L)
        idle, chunk_index, ran_total = 0, 0, 0
        budget = self._agree(budget, ran_total)
        try:
            while True:
                live = [i for i in range(L) if not lanes.done[i] and lanes.steps[i] < num_steps]
                if not live:
                    break
                K = min(budget, num_steps - min(lanes.steps[i] for i in live))
                warmup = step.warming
                if warmup:
                    K = min(K, GRAPH_WARMUP - step.warm)
                if any(lanes.retry[i] for i in live):
                    # a re-sample is a chunk of its own: in a NaN storm it
                    # halts again, and no iteration runs after it
                    K = 1
                t0, captures_s = time.perf_counter(), graph_counts["captures_s"]
                last = 0
                for j in range(K):
                    if j >= POLL_LAG and _all_stopped(reads.read(j - POLL_LAG), num_steps):
                        break
                    for i in live:
                        if lanes.steps[i] + j < num_steps:  # the healthy schedule
                            kt = lanes.key(i, lanes.steps[i] + j, lanes.retry[i] if j == 0 else 0)
                            buf.put_noise(i, lane_noise(kt, True))
                    ran = step()
                    ran_total += 1
                    reads.record(j)
                    last = j
                status = reads.read(last).copy()  # the chunk's one host read
                graph_counts["reads"] += 1
                graph_counts["wasted"] += int(status[3, 0]) - idle
                idle = int(status[3, 0])
                before = min(lanes.steps[i] for i in live)
                halted, give_up = lanes.take(status, live, self.max_nan_retries)
                if halted:
                    self._restart(buf, halted, give_up, lr0, p0)
                elapsed = time.perf_counter() - t0
                graph_counts[ran + "_s"] += elapsed - (graph_counts["captures_s"] - captures_s)
                if chunk is None and self.chunk_target_s and not warmup:
                    # the next chunk fits chunk_target_s at this chunk's rate;
                    # the call's first chunk (its capture included) is not kept
                    rate = (max(min(lanes.steps[i] for i in live) - before, 1)
                            / max(elapsed, 1e-6))
                    budget = max(25, int(self.chunk_target_s * rate))
                    if chunk_index > 0:
                        object.__setattr__(self, "_measured_rate", rate)
                    chunk_index += 1
                budget = self._agree(budget, ran_total)
                if on_read is not None:
                    on_read()
        finally:
            step.close()
        if self.mesh is not None:  # the last rollouts of every particle
            for name in ("states", "inputs"):
                setattr(buf, name, mesh_mod.all_gather(self.mesh, getattr(buf, name),
                                                       mesh_mod.PARTICLE_AXIS, dim=2))
        return self._lane_results(buf, lanes.steps, lanes.reinits)

    def _agree(self, budget: int, iterations: int) -> int:
        """Under a particle mesh, at the start of a call and after each read:
        one chunk budget for every rank of the particle group (the largest:
        each rank sizes it from its own clock), and a check that every rank
        ran the device body as often (a rank that runs it once more would
        wait forever in its collectives).  Without a mesh: ``budget``."""
        group = self._particle_group()
        if group is None:
            return budget
        t = torch.tensor([budget, iterations, -iterations], dtype=torch.int64,
                         device=self.mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        most, fewest = int(t[1]), -int(t[2])
        if most != fewest:
            raise RuntimeError(f"the ranks of a particle group ran the optimizer's device body "
                               f"{fewest} to {most} times; they must run it equally often")
        return int(t[0])

    def _body(self, buf: _Static, gp_params, posterior, trial_index, mask, num_steps) -> None:
        """One iteration of every lane, on the device: the rollout from
        ``buf.noise`` at ``buf.leaves``, its policy gradient (masked and
        clipped), Adam's candidate step, the monitor, and on the lanes that
        advanced (live, cost not NaN) the writes of the loop state, the
        histories at the step, the best params, the last rollout, the
        candidate params and moments.  A live lane whose cost is NaN halts.
        It reads no tensor but ``buf``'s, the posterior and the GP
        parameters, draws no random number, makes no tensor from host data
        and reads nothing back: on CUDA it is what the graph captures."""
        lane, noise, rate = buf.lane, buf.noise, 0.0
        if buf.dropout:
            rate = lane["p_drop"]
            keep_prob = torch.clamp(1.0 - rate, min=1e-6)
            noise = noise._replace(keep=noise.keep < keep_prob.reshape(1, -1, 1, 1))
        cost, (std, states, inputs) = self._rollout_cost(buf.leaves, gp_params, posterior, None,
                                                         rate, trial_index, noise)
        names = list(buf.leaves)
        grads = torch.autograd.grad(cost.sum(), [buf.leaves[k] for k in names])
        group = self._particle_group()
        if group is not None:  # this rank's share of the gradient: sum the shares
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        grads = self._masked_grads(dict(zip(names, grads)), mask)
        b1, b2, eps = self.adam_b1, self.adam_b2, self.adam_eps
        with torch.no_grad():
            cost, std = cost.detach(), std.detach()
            step, count = lane["step"], lane["adam_count"]
            t = (count + 1).to(torch.float32)
            lr, bc1, bc2 = lane["lr"], 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
            m = {k: b1 * buf.m[k] + (1 - b1) * g for k, g in grads.items()}
            v = {k: b2 * buf.v[k] + (1 - b2) * g * g for k, g in grads.items()}
            new = {k: p - _per_lane(lr, p) * (m[k] / _per_lane(bc1, p))
                   / (torch.sqrt(v[k] / _per_lane(bc2, p)) + eps) for k, p in buf.leaves.items()}

            live = (lane["done"] == 0) & (lane["halted"] == 0) & (step < num_steps)
            nan = torch.isnan(cost)
            ok = live & ~nan
            mon, reduce_lr, exit_now = self.monitor_update(
                Monitor(*(lane[k] for k in Monitor._fields)), step, cost - lane["cost_prev"])
            improved = ok & (cost < lane["best_cost"])
            for k, b in buf.best.items():  # the params that scored the cost
                b.copy_(torch.where(_lane_mask(improved, b), buf.leaves[k], b))
            for k, p in buf.leaves.items():
                p.copy_(torch.where(_lane_mask(ok, p), new[k], p))
            # a plateau's lr reduction restarts that lane's Adam moments
            moved, reset = ok & ~reduce_lr, ok & reduce_lr
            for state, cand in ((buf.m, m), (buf.v, v)):
                for k, s in state.items():
                    s.copy_(torch.where(_lane_mask(moved, s), cand[k], s)
                            .masked_fill_(_lane_mask(reset, s), 0.0))
            at = torch.clamp(step, max=self.max_opt_steps - 1).long().reshape(1, -1, 1).expand(
                2, -1, 1)
            logged = torch.where(ok, torch.stack([cost, std]), buf.hist.gather(2, at).squeeze(2))
            buf.hist.scatter_(2, at, logged.unsqueeze(2))
            for last, now in ((buf.states, states), (buf.inputs, inputs)):
                last.copy_(torch.where(_lane_mask(ok, last, axis=1), now.detach(), last))
            f = dict(mon._asdict(), cost_prev=cost,
                     best_cost=torch.where(improved, cost, lane["best_cost"]))
            i = dict(step=step + 1, done=lane["done"] | exit_now, halted=lane["halted"],
                     idle=lane["idle"], consec=mon.consec, adam_count=(count + 1) * ~reduce_lr)
            buf.floats.copy_(torch.where(ok, torch.stack([f[k] for k in _FLOATS]), buf.floats))
            buf.ints.copy_(torch.where(ok, torch.stack([i[k].to(torch.int32) for k in _INTS]),
                                       buf.ints))
            lane["halted"].bitwise_or_((live & nan).to(torch.int32))
            lane["idle"].add_((~live.any()).to(torch.int32))

    def _restart(self, buf: _Static, halted: list, give_up: dict, lr0, p_dropout0) -> None:
        """After a read: the ``halted`` lanes run again (from their next
        key); the lanes of ``give_up`` (lane -> policy-init key) first log
        cost_prev for the step, advance it, and re-initialize policy, Adam
        and monitor (the JAX loop's ``reinit_all``)."""
        dev, lane = buf.floats.device, buf.lane
        with torch.no_grad():
            lane["halted"][torch.tensor(halted, device=dev)] = 0
            if not give_up:
                return
            ix = torch.tensor(list(give_up), device=dev)
            at = lane["step"][ix].long()
            buf.hist[0, ix, at] = lane["cost_prev"][ix]
            buf.hist[1, ix, at] = 0.0
            lane["step"][ix] += 1
            self._reset_monitor(buf, ix, lr0, p_dropout0)
            fresh = self.engine.policy.reinit({k: t[ix] for k, t in buf.leaves.items()},
                                              list(give_up.values()))
            for k, t in buf.leaves.items():
                t.index_copy_(0, ix, fresh[k])
            for state in (buf.m, buf.v):
                for t in state.values():
                    t.index_fill_(0, ix, 0.0)

    def _lane_results(self, buf: _Static, steps, reinits):
        floats = dict(zip(_FLOATS, buf.floats.cpu().numpy()))
        hist = buf.hist.cpu()
        results, metric = [], []
        for i, steps_done in enumerate(steps):
            best_cost = float(floats["best_cost"][i])
            final = buf.best if self.keep_best and np.isfinite(best_cost) else buf.leaves
            results.append(OptResult(
                policy_params={k: t[i].detach() for k, t in final.items()},
                cost_history=hist[0, i].clone(),
                std_history=hist[1, i].clone(),
                steps_done=steps_done,
                states=buf.states[:, i],
                inputs=buf.inputs[:, i],
                reinit_count=reinits[i],
                final_lr=float(floats["lr"][i]),
                final_p_dropout=float(floats["p_drop"][i]),
            ))
            metric.append(best_cost if self.keep_best else float(floats["cost_prev"][i]))
        return results, np.asarray(metric, dtype=np.float64)
