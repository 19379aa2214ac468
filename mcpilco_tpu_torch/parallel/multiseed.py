"""Lane-batched multi-seed MC-PILCO training on one card: the seed farm.

The port of ``mcpilco_tpu/parallel/multiseed.py``.  Every stage is a
function of the seed's key, so S seeds train together, each against its own
data, GP and posterior, with the seeds as a leading lane axis where the JAX
package ``vmap``s over them:

- **collect**: one RK4 loop rolls every seed's plant trial
  (``rollout_lanes`` of ``ODEPlant`` and ``PMSODEPlant``), and for 4PMS
  one device call estimates every seed's velocities offline
  (``offline_velocity_estimation_lanes``); a host plant (MuJoCo) rolls its
  seeds one after another (``_collect_host``);
- **fit**: one batched Adam over the S x G GP heads, with the NaN guard
  acting per seed; per-seed SOD selection in one batched loop, each seed in
  its own candidate order under ``SODConfig.permutation``; the
  posterior built at 1x / 10x / 100x jitter, and per seed the first finite
  one kept (``gp.first_finite``);
- **optimize**: ``PolicyOptimizer.optimize_lanes`` with one lane per seed,
  whose predict launches K1/K2 once per rollout step for all seeds.

The key derivations are those of the sequential ``MCPilco`` (``collect``,
``_sample_x0``, ``_sod_key``, ``improve_policy``), so a farmed seed draws
what the same seed trained alone draws.  ``num_restarts > 1`` runs as sequential restart
lanes through the S-lane loop, keeping each seed's winner.

Scope: the plants of the JAX package's farm: ODE plants (the flagship and
multi-init cart-pole, 4PMS, Furuta) on the device, any other plant with a
``rollout()`` on the host.  SOR, a host plant with offline filtering and a
plant without ``rollout()`` raise, as in the JAX farm.

With a ``mesh`` (``parallel/mesh.py``, one process per device), seed group
g of the mesh's seed axis (``"s"``, or a 1D mesh's one axis) farms its own
``len(seeds) / groups`` seeds, under their own keys, and ``run`` gathers
every group's results in seed order on every rank.  On a shared 2D
``("s", "p")`` mesh each group's optimizer also shards its particles over
``"p"``.  A group computes what one farm of its own seeds computes, bit
for bit on the same device: the groups exchange nothing before the results.

The optimizer reads the lanes back once per chunk of iterations, sized as
the JAX farm sizes its chunks: the first by ``first_chunk_steps`` (the
seeds and the horizon scale a chunk's device time), the later ones by what
the last chunk's rate fits into ``PolicyOptimizer.chunk_target_s``;
``SeedFarm.chunk_steps_override`` fixes every chunk instead.  No number
depends on the chunks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..control.mc_pilco import MCPilco, ModelFitOptions, PolicyOptOptions
from ..envs.plants import ODEPlant, offline_velocity_estimation_lanes
from ..models import sod as sod_mod
from ..models.gp import GPData, first_finite, tree_map
from ..ops import linalg
from ..utils import prng
from . import mesh as mesh_mod

JITTER_SCALES = (1.0, 10.0, 100.0)


class FarmTrialLog(NamedTuple):
    """Per-trial training record of every seed (leading axis: seeds)."""

    cost_history: np.ndarray  # [S, max_opt_steps]
    steps_done: np.ndarray  # [S]
    reinit_count: np.ndarray  # [S]
    mll_last: np.ndarray  # [S]
    control_true: np.ndarray  # [S, N+1, ds] the executed control trial
    control_inputs: np.ndarray  # [S, N+1, du]
    wall_clock_s: float


class FarmResult(NamedTuple):
    seeds: np.ndarray  # [S]
    trial_logs: List[FarmTrialLog]
    policy_params: dict  # leading axis S

    @property
    def final_true(self) -> np.ndarray:
        return self.trial_logs[-1].control_true

    @property
    def final_inputs(self) -> np.ndarray:
        return self.trial_logs[-1].control_inputs


def first_chunk_steps(chunk_steps: int, num_seeds: int, horizon: int) -> int:
    """Iterations of a farm call's first chunk: the optimizer's
    ``chunk_steps`` at 60 horizon steps for two seeds, scaled down by the
    seeds and the horizon, at least 25 (``mcpilco_tpu/parallel/
    multiseed.py:478-481``)."""
    return max(25, 2 * chunk_steps * 60 // (max(num_seeds, 1) * max(horizon, 1)))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _pad_to(v: np.ndarray, size: int, axis: int) -> np.ndarray:
    widths = [(0, 0)] * v.ndim
    widths[axis] = (0, size - v.shape[axis])
    return np.pad(v, widths)


@dataclasses.dataclass
class SeedFarm:
    """Trains ``seeds`` together with ``agent``'s configuration, on its device.

    ``policy_init_fn(key) -> params`` initializes one seed's policy from its
    root key (e.g. ``lambda k: cartpole.policy_init(cfg, agent.policy, k,
    device)``); by default the policy's own ``init_params``.
    ``mesh`` shards the seeds over the mesh's seed groups (the module's
    docstring); ``local_seeds`` are this rank's.
    ``chunk_steps_override`` fixes the optimizer's iterations per host read
    for every chunk (profiling); by default the first chunk follows
    :func:`first_chunk_steps` and the later ones adapt.  ``progress_cb`` (no
    arguments) is called at every return to the host: after every
    collection, model fit and read of the optimizer's lanes, so a healthy
    farm ticks at least every ``chunk_target_s`` seconds of optimization.
    """

    agent: MCPilco
    seeds: Sequence[int]
    mesh: Optional[object] = None
    policy_init_fn: Optional[Callable] = None
    chunk_steps_override: Optional[int] = None
    progress_cb: Optional[Callable] = None

    def __post_init__(self):
        a = self.agent
        # ODE plants roll all seeds in one loop on the device; any other plant
        # (MuJoCo) runs seed by seed on the host through its rollout()
        self._device_plant = isinstance(a.plant, ODEPlant)
        if not self._device_plant and not hasattr(a.plant, "rollout"):
            raise ValueError("the seed farm needs a plant with a rollout() protocol, got "
                             f"{type(a.plant).__name__}")
        if not self._device_plant and a.offline_filtering:
            raise ValueError("the seed farm has no offline filtering for a host plant; train "
                             "such seeds one at a time")
        if getattr(a, "sor", None) is not None:
            raise ValueError("the seed farm has no SOR path; train SOR seeds one at a time")
        m = a.optimizer.mesh
        if m is not None and not (m is self.mesh and mesh_mod.SEED_AXIS in m.axis_names
                                  and mesh_mod.PARTICLE_AXIS in m.axis_names):
            raise ValueError(
                "the seed farm composes with particle-axis sharding only on a shared 2D "
                "('s', 'p') mesh (parallel.mesh.make_seed_particle_mesh); a plain particle "
                "mesh on the optimizer conflicts with the farm's seed axis")
        # this rank's seeds: its seed group's share, or all of them
        self.local_seeds = (list(self.seeds) if self.mesh is None
                            else mesh_mod.shard_seeds(self.mesh, self.seeds))
        dev = a.device
        self.keys = [prng.root_key(s) for s in self.local_seeds]
        init = self.policy_init_fn or (lambda k: a.policy.init_params(
            prng.fold(prng.stream(k, prng.STREAM_POLICY_INIT), 0), device=dev))
        self.policy_params = _stack([init(k) for k in self.keys])
        self.expl_params = _stack([a.exploration_policy.init_params(
            prng.fold(prng.stream(k, prng.STREAM_EXPLORATION), 0), device=dev) for k in self.keys])
        self.gp_params = None
        self.posterior = None
        self.num_collections = 0
        S = len(self.local_seeds)
        self.gp_x = np.zeros((S, 0, a.model.gp_input_dim), np.float32)
        self.gp_y = np.zeros((S, a.gp.num_heads, 0), np.float32)

    def _tick(self):
        if self.progress_cb is not None:
            self.progress_cb()

    # ---------------------------------------------------------- data

    def _sample_x0(self, key, trial_index: int) -> np.ndarray:
        a = self.agent
        if a.fixed_initial_state:
            mean = np.asarray(a.init_dist.mean, np.float32)
            return mean[0] if mean.ndim == 2 else mean
        k = prng.fold(prng.stream(key, prng.STREAM_SYSTEM), trial_index, 0xA)
        return a.init_dist.sample_single(k).numpy()

    def collect(self, T: float, trial_index: int, exploration: bool) -> tuple:
        """One plant trial per seed with ``MCPilco.collect``'s keys, in one
        RK4 loop for an ODE plant, seed by seed for a host plant; adds the
        trials to the seeds' datasets.  With offline filtering (4PMS) the
        model data are every seed's offline estimates, made in one device
        call.  Returns the true states [S, N, ds] and inputs [S, N, du],
        trimmed to [1:-1] with offline filtering as the sequential path
        trims them."""
        a = self.agent
        if not self._device_plant:
            return self._collect_host(T, trial_index, exploration)
        pol = a.exploration_policy if exploration else a.policy
        params = self.expl_params if exploration else self.policy_params
        x0 = np.stack([self._sample_x0(k, trial_index) for k in self.keys])
        keys = [prng.fold(prng.stream(k, prng.STREAM_SYSTEM), trial_index) for k in self.keys]
        trial = a.plant.rollout_lanes(keys, x0, pol, params, T, a.dt, device=a.device)
        if not a.offline_filtering:
            return self._add(trial.measured, trial.inputs, trial.true)
        est, inputs = offline_velocity_estimation_lanes(
            torch.as_tensor(trial.noisy, device=a.device),
            torch.as_tensor(trial.inputs, device=a.device), a.dt, a.model.pos_indices,
            a.model.vel_indices, filt_cutoff=a.offline_filter_cutoff,
            method=a.offline_filter_method)
        return self._add(est.cpu().numpy(), inputs.cpu().numpy(), trial.true[:, 1:-1])

    def _collect_host(self, T: float, trial_index: int, exploration: bool) -> tuple:
        """A host plant's trials (MuJoCo), seed by seed through its
        ``rollout`` with the sequential path's keys and initial states."""
        a = self.agent
        pol = a.exploration_policy if exploration else a.policy
        params = self.expl_params if exploration else self.policy_params
        trials = [a.plant.rollout(prng.fold(prng.stream(k, prng.STREAM_SYSTEM), trial_index),
                                  self._sample_x0(k, trial_index), pol,
                                  {n: v[i] for n, v in params.items()}, T, a.dt,
                                  device=a.device)
                  for i, k in enumerate(self.keys)]
        return self._add(*(np.stack([getattr(t, f) for t in trials])
                           for f in ("measured", "inputs", "true")))

    def _add(self, measured, inputs, true) -> tuple:
        """Every seed's training pairs of one trial into its dataset:
        ``measured`` [S, N, ds] and ``inputs`` [S, N, du] on the host."""
        a = self.agent
        pairs = [a.model.training_pairs(torch.as_tensor(m, dtype=torch.float32),
                                        torch.as_tensor(u, dtype=torch.float32))
                 for m, u in zip(measured, inputs)]
        self.gp_x = np.concatenate([self.gp_x, np.stack([x.numpy() for x, _ in pairs])], axis=1)
        self.gp_y = np.concatenate([self.gp_y, np.stack([y.numpy() for _, y in pairs])], axis=2)
        self.num_collections += 1
        self._tick()
        return true, inputs

    def _padded_data(self) -> GPData:
        a = self.agent
        S, n, d = self.gp_x.shape
        cap = linalg.bucket_size(n, a.bucket, a.bucket)
        x = np.zeros((S, cap, d), np.float32)
        y = np.zeros((S, self.gp_y.shape[1], cap), np.float32)
        x[:, :n], y[:, :, :n] = self.gp_x, self.gp_y
        mask = np.zeros((S, cap), np.float32)
        mask[:, :n] = 1.0
        return GPData(*(torch.as_tensor(v, device=a.device) for v in (x, y, mask)))

    # ---------------------------------------------------------- model

    def fit_model(self, opts: ModelFitOptions) -> np.ndarray:
        """Re-init and train every seed's GP heads in one batched fit, then
        build the posteriors.  Returns each seed's final MLL [S]."""
        a = self.agent
        S = len(self.local_seeds)
        p0 = a._init_gp_params()
        params = tree_map(lambda t: t.expand(S, *t.shape).clone(), p0)
        data = self._padded_data()
        self.gp_params, losses = a.gp.fit(params, data, num_epochs=opts.num_epochs,
                                          learning_rate=opts.learning_rate)
        self.posterior = self._build_posterior(data)
        out = losses[:, -1].cpu().numpy()
        self._tick()
        return out

    @torch.no_grad()
    def _build_posterior(self, data: GPData):
        """Every seed's posterior at 1x, 10x and 100x jitter, and per seed the
        first finite one (``multiseed.py:318-355``): an fp32 Cholesky can tip
        over on one seed's dataset, and a NaN posterior NaN-storms its whole
        training."""
        a = self.agent
        variants = [a.gp.scaled(s) for s in JITTER_SCALES]
        if a.sod is None:
            return first_finite([gv.fit_posterior(self.gp_params, data) for gv in variants])
        parts = [self._sod_subsets(gv, data) for gv in variants]
        m = max(x.shape[1] for x, _, _ in parts)
        posts = []
        for gv, (x_tr, mask, y_tr) in zip(variants, parts):
            padded = (_pad_to(x_tr, m, 1), _pad_to(mask, m, 2), _pad_to(y_tr, m, 2))
            posts.append(gv.posterior(self.gp_params,
                                      *(torch.as_tensor(v, device=a.device) for v in padded)))
        return first_finite(posts)

    def _sod_subsets(self, gp, data: GPData):
        """Per seed, the SOD selection compacted to the union of the heads'
        subsets as ``MCPilco._build_posterior_once`` does it, the seeds padded
        to the largest bucket: (x_tr [S, M, D], mask [S, G, M], y [S, G, M])."""
        a = self.agent
        keys = [prng.fold(prng.stream(k, prng.STREAM_MODEL_FIT), self.num_collections)
                for k in self.keys]
        sel = sod_mod.select(gp, a.sod, self.gp_params, data.x, data.y, data.mask, keys)
        sel_np = sel.cpu().numpy() > 0.5
        unions = [np.where(s.any(axis=0))[0] for s in sel_np]
        m = max(linalg.bucket_size(len(u), a.bucket, a.bucket) for u in unions)
        x_np, y_np = data.x.cpu().numpy(), data.y.cpu().numpy()
        S, G = sel_np.shape[:2]
        x_tr = np.zeros((S, m, x_np.shape[-1]), np.float32)
        y_tr = np.zeros((S, G, m), np.float32)
        mask = np.zeros((S, G, m), np.float32)
        for i, u in enumerate(unions):
            x_tr[i, : len(u)] = x_np[i, u]
            y_tr[i, :, : len(u)] = y_np[i][:, u]
            mask[i, :, : len(u)] = sel_np[i][:, u]
        return x_tr, mask, y_tr

    # ---------------------------------------------------------- policy

    def improve_policy(self, opts: PolicyOptOptions, trial_index: int) -> tuple:
        """Every seed's policy optimization, as lanes of one loop.

        ``optimizer.num_restarts > 1`` runs the restarts one after another:
        restart 0 from each seed's incoming params on the single-restart
        schedule, restart r from ``policy.reinit`` with the seed's
        ``split(fold(key, STREAM_RESTARTS), R - 1)[r - 1]``; each seed keeps
        its own winner.  Returns (cost_history [S, max_opt_steps],
        steps_done [S], reinit_count [S]).
        """
        a = self.agent
        R = max(int(a.optimizer.num_restarts), 1)
        keys = [prng.fold(prng.stream(k, prng.STREAM_ROLLOUT), trial_index) for k in self.keys]
        best, best_metric = None, None
        for r in range(R):
            params = self.policy_params
            if r:
                params = a.policy.reinit(params, [
                    prng.split(prng.fold(k, prng.STREAM_RESTARTS), R - 1)[r - 1] for k in keys])
            results, metric = self._optimize_lane(opts, trial_index, keys, params, lane_id=r)
            if best is None:
                best, best_metric = results, metric
                continue
            for i, (m_new, m_old) in enumerate(zip(metric, best_metric)):
                if np.isfinite(m_new) and (not np.isfinite(m_old) or m_new < m_old):
                    best[i], best_metric[i] = results[i], m_new
        self.policy_params = _stack([res.policy_params for res in best])
        return (np.stack([res.cost_history.numpy() for res in best]),
                np.asarray([res.steps_done for res in best]),
                np.asarray([res.reinit_count for res in best]))

    def _optimize_lane(self, opts: PolicyOptOptions, trial_index: int, keys, lane_params,
                       lane_id: int):
        """One restart lane of every seed: (one OptResult per seed, each
        seed's winner metric [S])."""
        opt = self.agent.optimizer
        return opt.optimize_lanes(
            keys, lane_params, self.gp_params, self.posterior, opts.opt_steps,
            opts.learning_rate, opts.p_dropout, trial_index, rids=[lane_id] * len(keys),
            chunk=self.chunk_steps_override,
            first_chunk=first_chunk_steps(opt.chunk_steps, len(self.local_seeds), opt.horizon),
            on_read=self._tick)

    # ---------------------------------------------------------- main loop

    def run(self, *, num_trials: int, T_exploration: float, T_control: float,
            model_fit_options: Sequence[ModelFitOptions],
            policy_opt_options: Sequence[PolicyOptOptions], num_explorations: int = 1,
            verbose: bool = True) -> FarmResult:
        """``MCPilco.reinforce`` for every seed at once."""
        for e in range(num_explorations):
            if verbose:
                print(f"[seed-farm] exploration {e} ({len(self.local_seeds)} seeds)")
            self.collect(T_exploration, trial_index=e, exploration=True)
        logs: List[FarmTrialLog] = []
        for trial in range(num_trials):
            t0 = time.time()
            mll_last = self.fit_model(model_fit_options[min(trial, len(model_fit_options) - 1)])
            if verbose:
                print(f"[seed-farm] trial {trial}: N={self.gp_x.shape[1]} mll_last median "
                      f"{np.median(mll_last):.1f} ({time.time() - t0:.1f}s)")
            t1 = time.time()
            cost_hist, steps, reinits = self.improve_policy(
                policy_opt_options[min(trial, len(policy_opt_options) - 1)], trial)
            if verbose:
                last = cost_hist[np.arange(len(self.local_seeds)), np.maximum(steps - 1, 0)]
                print(f"[seed-farm] trial {trial}: opt steps med {int(np.median(steps))}, final "
                      f"cost med {np.median(last):.2f}, reinits {int(reinits.sum())} "
                      f"({time.time() - t1:.1f}s, "
                      f"{1e3 * (time.time() - t1) / max(int(steps.max()), 1):.2f} "
                      f"ms/step-all-seeds)")
            true_states, inputs = self.collect(T_control, trial_index=self.num_collections,
                                               exploration=False)
            logs.append(FarmTrialLog(cost_history=cost_hist, steps_done=steps,
                                     reinit_count=reinits, mll_last=mll_last,
                                     control_true=true_states, control_inputs=inputs,
                                     wall_clock_s=time.time() - t0))
        if self.mesh is not None:
            return self._gathered(logs)
        return FarmResult(seeds=np.asarray(list(self.seeds)), trial_logs=logs,
                          policy_params=self.policy_params)

    def _gathered(self, logs: List[FarmTrialLog]) -> FarmResult:
        """Every seed group's logs and policies, in seed order (the seed
        axis's coordinate order), on every rank."""
        mine = ([log._asdict() for log in logs],
                {k: v.cpu().numpy() for k, v in self.policy_params.items()})
        parts = mesh_mod.gather_objects(self.mesh, mine, mesh_mod.seed_axis(self.mesh))
        trial_logs = []
        for t in range(len(logs)):
            rows = [p[0][t] for p in parts]
            trial_logs.append(FarmTrialLog(**{
                f: (max(r[f] for r in rows) if f == "wall_clock_s"
                    else np.concatenate([r[f] for r in rows])) for f in FarmTrialLog._fields}))
        dev = self.agent.device
        params = {k: torch.as_tensor(np.concatenate([p[1][k] for p in parts]), device=dev)
                  for k in self.policy_params}
        return FarmResult(seeds=np.asarray(list(self.seeds)), trial_logs=trial_logs,
                          policy_params=params)
