"""The MC-PILCO orchestrator: explore -> fit GPs -> optimize policy -> apply.

A host-side trial loop with the responsibilities of
``mcpilco_tpu/control/mc_pilco.py``: system interaction (``envs.plants``),
model fitting (``MultiGP.fit``, SOD selection, posterior build) and policy
optimization (``trainer.PolicyOptimizer``), all on ``device``.  The dataset
accumulates on the host and is padded to shape buckets per fit.

With a ``log_dir``, ``reinforce`` writes a checkpoint after each stage of a
trial (``utils/checkpoint.py``, the JAX package's npz/json layout, so either
package resumes the other's runs); ``auto_resume`` continues from the newest
completed trial.  A hardware rig feeds trials through ``add_external_trial``
or the CSV file protocol (``load_external_trial``) and takes the policy as
CSV files (``export_policy_csv``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import disable_tf32
from ..envs.plants import TrialData, offline_velocity_estimation
from ..models import sod as sod_mod
from ..models.costs import CostBase
from ..models.dynamics import DynamicsModel
from ..models.gp import GPData, GPParams, MultiGP
from ..models.policies import PolicyBase
from ..ops import linalg
from ..utils import checkpoint as ckpt
from ..utils import prng
from .rollout import InitialStateDistribution
from .trainer import OptResult, PolicyOptimizer


@dataclasses.dataclass(frozen=True)
class ModelFitOptions:
    """Per-trial GP training options."""

    num_epochs: int = 1501
    learning_rate: float = 0.01


@dataclasses.dataclass(frozen=True)
class PolicyOptOptions:
    """Per-trial knobs of the policy optimizer."""

    opt_steps: int
    learning_rate: float = 0.01
    p_dropout: float = 0.0


@dataclasses.dataclass
class TrialLog:
    cost_history: np.ndarray
    std_history: np.ndarray
    steps_done: int
    particles_states: np.ndarray
    particles_inputs: np.ndarray
    reinit_count: int
    wall_clock_s: float
    # with num_restarts > 1: each restart's winner metric, and the winner
    restart_costs: Optional[np.ndarray] = None
    restart_winner: Optional[int] = None


def complete_trials(log_dir: str) -> dict:
    """{trial index: path} of the ``complete_trial<i>`` checkpoints in
    ``log_dir`` (a directory without its manifest is no checkpoint)."""
    found = {}
    for path in glob.glob(os.path.join(log_dir, "complete_trial*")):
        m = re.search(r"complete_trial(\d+)$", path)
        if m and os.path.isfile(os.path.join(path, "manifest.json")):
            found[int(m.group(1))] = path
    return found


def scenario_meta(name: Optional[str], config) -> Optional[dict]:
    """A checkpoint's ``scenario`` meta: the scenario's name and config."""
    if config is None:
        return None
    return {"name": name, "config": dataclasses.asdict(config)}


def checkpoint_state(*, seed: int, policy_params, expl_params, gp_x, gp_y, gp_params,
                     num_collections: int, num_exploration_trials: int, dt: float, stage: str,
                     scenario: Optional[dict], trials: List[TrialData],
                     trial_logs: List[TrialLog]) -> Tuple[dict, dict]:
    """The (trees, meta) of a checkpoint: tree names, leaf order and meta
    keys are the JAX package's; the restart fields ride along in
    ``trial_log_scalars``.  ``MCPilco.save_checkpoint`` writes them, and the
    seed farm each lane's (``SeedFarm.save_lanes``)."""
    trees = {"policy_params": policy_params, "expl_params": expl_params,
             "gp_x": gp_x, "gp_y": gp_y}
    if gp_params is not None:
        trees["gp_params"] = gp_params
    for i, l in enumerate(trial_logs):
        trees[f"trial_log_{i}"] = {
            "cost": l.cost_history,
            "std": l.std_history,
            "p_states": l.particles_states,
            "p_inputs": l.particles_inputs,
        }
    meta = {
        "seed": seed,
        "num_collections": num_collections,
        "num_exploration_trials": num_exploration_trials,
        "dt": dt,
        "stage": stage,
        "scenario": scenario,
        "trial_measured": [t.measured.tolist() for t in trials],
        "trial_inputs": [t.inputs.tolist() for t in trials],
        "trial_true": [t.true.tolist() for t in trials],
        "trial_noisy": [t.noisy.tolist() for t in trials],
        "num_trial_logs": len(trial_logs),
        "trial_log_scalars": [
            {
                "steps_done": int(l.steps_done),
                "reinit_count": int(l.reinit_count),
                "wall_clock_s": float(l.wall_clock_s),
                "restart_costs": (None if l.restart_costs is None
                                  else np.asarray(l.restart_costs).tolist()),
                "restart_winner": (None if l.restart_winner is None
                                   else int(l.restart_winner)),
            }
            for l in trial_logs
        ],
    }
    return trees, meta


def check_resume(path: str, scenario: Optional[dict],
                 farm_seeds: Optional[List[int]] = None) -> None:
    """Refuse to resume from the checkpoint at ``path`` unless the same kind
    of run wrote it: a seed trained alone (``farm_seeds`` None) or the farm
    batch ``farm_seeds``: a seed's bits depend on the batch it shares.  Refuse
    it too when it was written under another scenario config (``scenario``,
    as ``scenario_meta`` gives it): log dirs outlive sweeps, and resuming
    after a config change would replay stale state as a fresh sample.  The
    configs are compared JSON-normalized, ``log_dir`` left out; no config
    check when either side has none."""
    meta = ckpt.peek_meta(path)
    stored_seeds = meta.get("farm_seeds")
    if stored_seeds != farm_seeds:
        def by(seeds):
            return "a seed trained alone" if seeds is None else f"the farm batch {seeds}"
        raise RuntimeError(
            f"resume refused: {path} was written by {by(stored_seeds)}, not by {by(farm_seeds)}"
            + ("; resume it with that batch's seeds and --farm-batch (repeat --farm --resume)"
               if stored_seeds is not None else "")
            + ", or delete it to start the seed afresh")
    stored = meta.get("scenario")
    if not stored or scenario is None:
        return
    current = json.loads(json.dumps(scenario, default=str))
    for side in (stored, current):
        side.get("config", {}).pop("log_dir", None)
    if stored == current:
        return
    s_cfg, c_cfg = stored.get("config", {}), current.get("config", {})
    diffs = [f"{k}: checkpoint={s_cfg.get(k)!r} current={c_cfg.get(k)!r}"
             for k in sorted(set(s_cfg) | set(c_cfg)) if s_cfg.get(k) != c_cfg.get(k)]
    if stored.get("name") != current.get("name"):
        diffs.insert(0, f"scenario: {stored.get('name')!r} vs {current.get('name')!r}")
    raise RuntimeError(
        f"resume refused: checkpoint {path} was written under a different scenario config "
        f"({'; '.join(diffs) or 'structural change'}). Delete the stale log dir (or re-run "
        "without resuming) to start fresh.")


class MCPilco:
    """Monte-Carlo PILCO on one device."""

    def __init__(
        self,
        *,
        dt: float,
        model: DynamicsModel,
        gp: MultiGP,
        policy: PolicyBase,
        exploration_policy: PolicyBase,
        cost: CostBase,
        optimizer: PolicyOptimizer,
        device,
        plant=None,
        init_dist: Optional[InitialStateDistribution] = None,
        sod: Optional[sod_mod.SODConfig] = None,
        sor: Optional[sod_mod.SORConfig] = None,
        offline_filtering: bool = False,
        offline_filter_cutoff: float = 0.5,
        offline_filter_method: str = "butter_cd",
        gp_sigma_n_init: float = 1.0,
        gp_init_overrides: Optional[list] = None,
        seed: int = 1,
        log_dir: Optional[str] = None,
        bucket: int = 64,
        fixed_initial_state: bool = False,
        mesh=None,
    ):
        disable_tf32()
        if mesh is not None:
            # the policy optimization's particles over the mesh's "p" axis
            # (trainer.PolicyOptimizer.mesh)
            optimizer = dataclasses.replace(optimizer, mesh=mesh)
        self.mesh = mesh
        self.device = torch.device(device)
        self.dt = dt
        self.model = model
        self.gp = gp
        self.policy = policy
        self.exploration_policy = exploration_policy
        self.cost = cost
        self.optimizer = optimizer
        self.plant = plant
        self.init_dist = init_dist or optimizer.init_dist
        self.sod = sod
        self.sor = sor
        if sor is not None and gp.approx != "sor":
            raise ValueError("sor config requires MultiGP(approx='sor')")
        # 4PMS model data: velocities re-estimated offline from the noisy
        # positions (envs.plants.offline_velocity_estimation)
        self.offline_filtering = offline_filtering
        self.offline_filter_cutoff = offline_filter_cutoff
        self.offline_filter_method = offline_filter_method
        self.gp_sigma_n_init = gp_sigma_n_init
        self.gp_init_overrides = gp_init_overrides
        self.seed = seed
        self.log_dir = log_dir
        self.bucket = bucket
        self.fixed_initial_state = fixed_initial_state
        # stamped by each scenario's build(), so that a checkpoint names the
        # config it was trained under (replay rebuilds it; auto-resume checks it)
        self.scenario_name: Optional[str] = None
        self.scenario_config = None

        self.key = prng.root_key(seed)
        self.policy_params = policy.init_params(
            prng.fold(prng.stream(self.key, prng.STREAM_POLICY_INIT), 0), device=self.device
        )
        self.expl_params = exploration_policy.init_params(
            prng.fold(prng.stream(self.key, prng.STREAM_EXPLORATION), 0), device=self.device
        )
        self.gp_params: Optional[GPParams] = None
        self.posterior = None

        # dataset accumulators (host side, unpadded)
        self.gp_x = np.zeros((0, model.gp_input_dim), np.float32)
        self.gp_y = np.zeros((gp.num_heads, 0), np.float32)
        self.trials: List[TrialData] = []
        self.trial_logs: List[TrialLog] = []
        self.num_collections = 0
        self.num_exploration_trials = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    # ------------------------------------------------------------ data

    def _ingest(self, trial: TrialData) -> None:
        states = torch.as_tensor(trial.measured, dtype=torch.float32)
        inputs = torch.as_tensor(trial.inputs, dtype=torch.float32)
        x, y = self.model.training_pairs(states, inputs)
        self.gp_x = np.concatenate([self.gp_x, x.numpy()], axis=0)
        self.gp_y = np.concatenate([self.gp_y, y.numpy()], axis=1)
        self.trials.append(trial)
        self.num_collections += 1

    def add_external_trial(self, measured: np.ndarray, inputs: np.ndarray,
                           exploration: bool = False) -> None:
        """Hardware-in-the-loop data entry: measured states [T, state_dim] and
        the applied inputs [T, input_dim] (a flat vector for input_dim = 1).
        Mark operator exploration runs with ``exploration=True`` so that
        per-trial cost schedules stay aligned with control-trial ordinals."""
        measured = np.asarray(measured, np.float32)
        inputs = np.asarray(inputs, np.float32).reshape(-1, self.model.input_dim)
        if measured.ndim != 2 or measured.shape[1] != self.model.state_dim:
            raise ValueError(
                f"measured states must be [T, {self.model.state_dim}], got {measured.shape}"
            )
        if inputs.shape[0] != measured.shape[0]:
            raise ValueError(
                f"inputs have {inputs.shape[0]} rows but measured states have "
                f"{measured.shape[0]} — one input per measured sample required"
            )
        # counted only once the trial is sure to be ingested: a rejected call
        # must not shift every later control-trial ordinal
        if exploration:
            self.num_exploration_trials += 1
        if self.offline_filtering:
            states, inputs = offline_velocity_estimation(
                measured, inputs, self.dt, self.model.pos_indices, self.model.vel_indices,
                filt_cutoff=self.offline_filter_cutoff, method=self.offline_filter_method,
            )
        else:
            states = measured
        self._ingest(TrialData(measured=states, inputs=inputs, true=states, noisy=measured))

    # ------------------------------------------------------- HIL file protocol
    # The rig side drops CSVs into <log_dir>/DATA_<trial>/ and reads the
    # policy parameters as CSVs: the layout of the JAX package's protocol.

    def export_policy_csv(self, out_dir: Optional[str] = None) -> List[str]:
        """Write every policy-parameter leaf as ``policy_<name>.csv``, ``name``
        the leaf's path joined by '_' (the JAX package's file names).  Returns
        the written paths."""
        out_dir = out_dir or self.log_dir
        if out_dir is None:
            raise ValueError("export_policy_csv needs an out_dir or a log_dir")
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for path, leaf in ckpt.flatten_with_path(self.policy_params):
            fp = os.path.join(out_dir, f"policy_{'_'.join(str(p) for p in path)}.csv")
            np.savetxt(fp, np.atleast_2d(leaf.detach().cpu().numpy()), delimiter=",")
            paths.append(fp)
        return paths

    def load_external_trial(self, trial_index: Optional[int] = None,
                            data_dir: Optional[str] = None,
                            exploration: bool = False) -> TrialData:
        """Ingest one hardware trial from ``<log_dir>/DATA_<trial>/
        {noisy_samples.csv, input_samples.csv}`` (or ``data_dir``).  Shape
        checks and offline filtering happen in :meth:`add_external_trial`;
        pass ``exploration=True`` for the operator's exploration run."""
        if data_dir is None:
            if self.log_dir is None:
                raise ValueError("load_external_trial needs a data_dir or a log_dir")
            idx = self.num_collections if trial_index is None else trial_index
            data_dir = os.path.join(self.log_dir, f"DATA_{idx}")
        noisy_fp = os.path.join(data_dir, "noisy_samples.csv")
        input_fp = os.path.join(data_dir, "input_samples.csv")
        for fp in (noisy_fp, input_fp):
            if not os.path.exists(fp):
                raise FileNotFoundError(f"expected hardware data file {fp}")
        noisy = np.genfromtxt(noisy_fp, delimiter=",")
        inputs = np.genfromtxt(input_fp, delimiter=",")
        self.add_external_trial(noisy, inputs, exploration=exploration)
        return self.trials[-1]

    def _padded_data(self) -> GPData:
        n = self.gp_x.shape[0]
        cap = linalg.bucket_size(n, self.bucket, self.bucket)
        x = np.zeros((cap, self.gp_x.shape[1]), np.float32)
        y = np.zeros((self.gp_y.shape[0], cap), np.float32)
        x[:n] = self.gp_x
        y[:, :n] = self.gp_y
        mask = np.zeros(cap, np.float32)
        mask[:n] = 1.0
        return GPData(*(torch.as_tensor(a, device=self.device) for a in (x, y, mask)))

    # ------------------------------------------------------------ system IO

    def _sample_x0(self, trial_index: int) -> np.ndarray:
        if self.fixed_initial_state:
            mean = np.asarray(self.init_dist.mean, np.float32)
            return mean[0] if mean.ndim == 2 else mean
        k = prng.fold(prng.stream(self.key, prng.STREAM_SYSTEM), trial_index, 0xA)
        return self.init_dist.sample_single(k).numpy()

    def collect(self, T: float, trial_index: int, exploration: bool) -> TrialData:
        """Interact with the plant and add the trial to the dataset."""
        if self.plant is None:
            raise RuntimeError(
                "no plant attached: supply data with add_external_trial() "
                "(hardware-in-the-loop mode)"
            )
        pol = self.exploration_policy if exploration else self.policy
        params = self.expl_params if exploration else self.policy_params
        x0 = self._sample_x0(trial_index)
        k = prng.fold(prng.stream(self.key, prng.STREAM_SYSTEM), trial_index)
        trial = self.plant.rollout(k, x0, pol, params, T, self.dt, device=self.device)
        if self.offline_filtering:
            states, inputs = offline_velocity_estimation(
                trial.noisy, trial.inputs, self.dt, self.model.pos_indices,
                self.model.vel_indices, filt_cutoff=self.offline_filter_cutoff,
                method=self.offline_filter_method,
            )
            trial = TrialData(measured=states, inputs=inputs, true=trial.true[1:-1],
                              noisy=trial.noisy[1:-1])
        self._ingest(trial)
        if exploration:
            self.num_exploration_trials += 1
        return trial

    # ------------------------------------------------------------ model

    def fit_model(self, opts: ModelFitOptions) -> dict:
        """Re-init the GP hyperparameters and train all heads."""
        t0 = time.time()
        self.gp_params = self._init_gp_params()
        data = self._padded_data()
        self.gp_params, losses = self.gp.fit(
            self.gp_params, data, num_epochs=opts.num_epochs, learning_rate=opts.learning_rate
        )
        info = {"mll_first": float(losses[0]), "mll_last": float(losses[-1])}
        self.posterior = self._build_posterior(data, info)
        info["wall_clock_s"] = time.time() - t0
        info["num_samples"] = int(self.gp_x.shape[0])
        return info

    def _init_gp_params(self) -> GPParams:
        return self.gp.init_params(sigma_n=self.gp_sigma_n_init,
                                   per_head_overrides=self.gp_init_overrides, device=self.device)

    def _build_posterior(self, data: GPData, info: Optional[dict] = None):
        """Exact, SOD-subset or SOR posterior, retried with 10x / 100x jitter
        if any posterior leaf is non-finite (an fp32 Cholesky can tip over on
        near-noiseless heads).  Each attempt starts from the fitted
        ``gp_params``: the SOR refinement replaces them."""
        gp0, params0 = self.gp, self.gp_params
        try:
            for scale in (1.0, 10.0, 100.0):
                if scale > 1.0:
                    self.gp = gp0.scaled(scale)
                    self.gp_params = params0
                post = self._build_posterior_once(data, info)
                if all(bool(torch.all(torch.isfinite(l))) for l in post):
                    if scale > 1.0:
                        print(f"[mc-pilco] posterior needed {scale:.0f}x jitter")
                    if info is not None:
                        info["jitter_scale"] = scale
                    return post
            raise FloatingPointError(
                "GP posterior non-finite even at 100x jitter escalation "
                f"(N={int(torch.sum(data.mask))}, jitter={gp0.jitter:g})"
            )
        finally:
            self.gp = gp0

    def _build_posterior_once(self, data: GPData, info: Optional[dict] = None):
        if self.sod is not None:
            with torch.no_grad():
                return self._sod_posterior(data, info)
        if self.sor is not None:
            return self._sor_posterior(data, info)
        with torch.no_grad():
            return self.gp.fit_posterior(self.gp_params, data)

    def _sod_key(self):
        """The key of the SOD / SOR candidate order (``SODConfig.permutation``)."""
        return prng.fold(prng.stream(self.key, prng.STREAM_MODEL_FIT), self.num_collections)

    def _sor_posterior(self, data: GPData, info: Optional[dict] = None):
        """Greedy inducing selection, the optional SOR-MLL refinement of the
        hyperparameters (and inducing inputs), then the SOR posterior."""
        with torch.no_grad():
            sel = sod_mod.select(self.gp, self.sor, self.gp_params, data.x, data.y, data.mask,
                                 self._sod_key())
        if info is not None:
            info["sor_points"] = sel.sum(dim=-1).cpu().numpy().tolist()
        u = None
        if self.sor.refine_epochs:
            self.gp_params, u_trained, losses = self.gp.fit_sor(
                self.gp_params, data, sel, num_epochs=self.sor.refine_epochs,
                learning_rate=self.sor.refine_lr, train_inducing=self.sor.train_inducing,
            )
            if self.sor.train_inducing:
                u = u_trained
            if info is not None:
                info["sor_mll_first"] = float(losses[0])
                info["sor_mll_last"] = float(losses[-1])
        with torch.no_grad():
            return self.gp.sor_posterior(self.gp_params, data, sel, u=u)

    def _sod_posterior(self, data: GPData, info: Optional[dict] = None):
        sel = sod_mod.select(self.gp, self.sod, self.gp_params, data.x, data.y, data.mask,
                             self._sod_key())
        sel_np = sel.cpu().numpy() > 0.5
        if info is not None:
            info["sod_points"] = sel_np.sum(axis=-1).tolist()
        # compact to the UNION of the per-head subsets, padded to a tight
        # bucket: x_tr stays shared by the heads (what the fused kernels
        # take) and M shrinks from the padded N
        g = self.gp.num_heads
        union = np.where(sel_np.any(axis=0))[0]
        m_cap = linalg.bucket_size(len(union), self.bucket, self.bucket)
        x_np, y_np = data.x.cpu().numpy(), data.y.cpu().numpy()
        x_tr = np.zeros((m_cap, x_np.shape[1]), np.float32)
        x_tr[: len(union)] = x_np[union]
        y_tr = np.zeros((g, m_cap), np.float32)
        y_tr[:, : len(union)] = y_np[:, union]
        mask = np.zeros((g, m_cap), np.float32)
        mask[:, : len(union)] = sel_np[:, union].astype(np.float32)
        return self.gp.posterior(
            self.gp_params, *(torch.as_tensor(a, device=self.device) for a in (x_tr, mask, y_tr))
        )

    # ------------------------------------------------------------ diagnostics

    @torch.no_grad()
    def one_step_mse(self, trial_index: int = -1) -> np.ndarray:
        """Per-head one-step prediction MSE on a stored trial."""
        trial = self.trials[trial_index]
        states = torch.as_tensor(trial.measured, dtype=torch.float32, device=self.device)
        inputs = torch.as_tensor(trial.inputs, dtype=torch.float32, device=self.device)
        x, y = self.model.training_pairs(states, inputs)
        mean, _ = self.gp.predict(self.gp_params, self.posterior, x)
        return torch.mean((mean - y) ** 2, dim=-1).cpu().numpy()

    @torch.no_grad()
    def trial_cumulative_cost(self, trial_index: int = -1) -> float:
        """Cumulative cost of an executed trial on the plant, the per-seed
        statistic of the repeat protocol.  A per-trial cost schedule is
        indexed by the control-trial ordinal, the index ``improve_policy``
        optimized with: exploration trials do not count."""
        trial = self.trials[trial_index]
        resolved = trial_index if trial_index >= 0 else len(self.trials) + trial_index
        resolved = max(0, resolved - self.num_exploration_trials)
        stage = self.cost.stage_costs(
            torch.as_tensor(trial.true[:, None, :]), torch.as_tensor(trial.inputs[:, None, :]),
            trial_index=resolved,
        )
        return float(torch.sum(stage))

    @torch.no_grad()
    def rollout_mse(self, trial_index: int = -1) -> np.ndarray:
        """Open-loop rollout MSE per state dim against a stored trial."""
        trial = self.trials[trial_index]
        traj = self.optimizer.engine.replay(
            self.gp_params,
            self.posterior,
            torch.as_tensor(trial.measured[0], dtype=torch.float32, device=self.device),
            torch.as_tensor(trial.inputs, dtype=torch.float32, device=self.device),
        )
        return np.mean((traj.cpu().numpy() - trial.measured) ** 2, axis=0)

    # ------------------------------------------------------------ policy

    def improve_policy(self, opts: PolicyOptOptions, trial_index: int) -> TrialLog:
        """One policy-optimization run."""
        t0 = time.time()
        k = prng.fold(prng.stream(self.key, prng.STREAM_ROLLOUT), trial_index)
        result: OptResult = self.optimizer.optimize(
            k,
            self.policy_params,
            self.gp_params,
            self.posterior,
            num_opt_steps=opts.opt_steps,
            lr0=opts.learning_rate,
            p_dropout0=opts.p_dropout,
            trial_index=trial_index,
        )
        self.policy_params = result.policy_params
        if result.restart_costs is not None:
            rc = ", ".join(f"{float(v):.2f}" for v in result.restart_costs)
            print(f"[mc-pilco] restarts: best costs [{rc}], winner lane {result.restart_winner}")
        steps = result.steps_done
        log = TrialLog(
            cost_history=result.cost_history.numpy()[:steps],
            std_history=result.std_history.numpy()[:steps],
            steps_done=steps,
            particles_states=result.states.cpu().numpy(),
            particles_inputs=result.inputs.cpu().numpy(),
            reinit_count=result.reinit_count,
            wall_clock_s=time.time() - t0,
            restart_costs=result.restart_costs,
            restart_winner=result.restart_winner,
        )
        self.trial_logs.append(log)
        return log

    # ------------------------------------------------------------ main loop

    def reinforce(
        self,
        *,
        num_trials: int,
        T_exploration: float,
        T_control: float,
        model_fit_options: List[ModelFitOptions],
        policy_opt_options: List[PolicyOptOptions],
        num_explorations: int = 1,
        verbose: bool = True,
        on_trial_end: Optional[Callable] = None,
    ):
        """The full MBRL loop, checkpointed after each stage of a trial when
        there is a ``log_dir``; ``on_trial_end(agent, trial)`` runs after each
        trial.  Returns the list of TrialLogs."""
        start_trial = len(self.trial_logs)
        if self.num_collections == 0:
            for e in range(num_explorations):
                if verbose:
                    print(f"[mc-pilco] exploration {e}")
                self.collect(T_exploration, trial_index=e, exploration=True)

        for trial in range(start_trial, start_trial + num_trials):
            if verbose:
                print(f"[mc-pilco] ===== trial {trial} =====")
            info = self.fit_model(model_fit_options[min(trial, len(model_fit_options) - 1)])
            if verbose:
                print(
                    f"[mc-pilco] model fit: N={info['num_samples']} "
                    f"mll {info['mll_first']:.1f} -> {info['mll_last']:.1f} "
                    f"({info['wall_clock_s']:.1f}s)"
                    + (f" sod={info.get('sod_points')}" if "sod_points" in info else "")
                )
                print(f"[mc-pilco] one-step MSE (last trial): {self.one_step_mse()}")
                print(f"[mc-pilco] rollout MSE  (last trial): {self.rollout_mse()}")
            self.save_checkpoint(stage=f"model_trial{trial}")

            log = self.improve_policy(
                policy_opt_options[min(trial, len(policy_opt_options) - 1)], trial
            )
            if verbose:
                c = log.cost_history
                cost_span = f"{c[0]:.2f} -> {c[-1]:.2f}" if len(c) else "(no steps)"
                print(
                    f"[mc-pilco] policy opt: {log.steps_done} steps, cost "
                    f"{cost_span}, reinits={log.reinit_count}, "
                    f"{log.wall_clock_s:.1f}s "
                    f"({1e3 * log.wall_clock_s / max(log.steps_done, 1):.2f} ms/step)"
                )
            self.save_checkpoint(stage=f"policy_trial{trial}")

            if self.plant is not None:
                self.collect(T_control, trial_index=self.num_collections, exploration=False)
                if verbose:
                    print(f"[mc-pilco] pre-update one-step MSE: {self.one_step_mse()}")
                    print(f"[mc-pilco] pre-update rollout  MSE: {self.rollout_mse()}")
                self.save_checkpoint(stage=f"complete_trial{trial}")
            if on_trial_end is not None:
                on_trial_end(self, trial)
        return self.trial_logs

    # ------------------------------------------------------------ persistence

    def auto_resume(self) -> int:
        """Restore the newest post-interaction checkpoint (``complete_trial<i>``)
        in ``log_dir``; ``reinforce`` then continues at the next trial.
        Returns the number of completed trials restored (0: nothing to
        resume).  Raises on a checkpoint of another scenario config or of a
        farm lane (``check_resume``)."""
        found = complete_trials(self.log_dir) if self.log_dir else {}
        if not found:
            return 0
        latest = found[max(found)]
        check_resume(latest, scenario_meta(self.scenario_name, self.scenario_config))
        self.load_checkpoint(latest)
        return len(self.trial_logs)

    def save_checkpoint(self, stage: str) -> None:
        """Write the agent's state to ``<log_dir>/<stage>`` (no-op without a
        log dir), as ``checkpoint_state`` lays it out."""
        if not self.log_dir:
            return
        trees, meta = checkpoint_state(
            seed=self.seed, policy_params=self.policy_params, expl_params=self.expl_params,
            gp_x=self.gp_x, gp_y=self.gp_y, gp_params=self.gp_params,
            num_collections=self.num_collections,
            num_exploration_trials=self.num_exploration_trials, dt=self.dt, stage=stage,
            scenario=scenario_meta(self.scenario_name, self.scenario_config),
            trials=self.trials, trial_logs=self.trial_logs)
        ckpt.save(os.path.join(self.log_dir, stage), trees, meta)

    def load_checkpoint(self, path: str) -> None:
        """Restore params, dataset, trials and trial logs from a checkpoint
        directory written by either package, then rebuild the posterior on
        ``device``."""
        templates = {
            "policy_params": self.policy_params,
            "expl_params": self.expl_params,
            "gp_x": self.gp_x,
            "gp_y": self.gp_y,
            "gp_params": self.gp_params if self.gp_params is not None else self._init_gp_params(),
        }
        trees, meta = ckpt.load(path, templates, self.device)
        self.policy_params = trees["policy_params"]
        self.expl_params = trees["expl_params"]
        self.gp_x = np.asarray(trees["gp_x"], np.float32).reshape(-1, self.model.gp_input_dim)
        self.gp_y = np.asarray(trees["gp_y"], np.float32).reshape(self.gp.num_heads, -1)
        self.gp_params = trees["gp_params"]
        self.num_collections = int(meta["num_collections"])
        self.num_exploration_trials = int(meta.get("num_exploration_trials", 0))
        noisy = meta.get("trial_noisy") or meta["trial_measured"]
        self.trials = [
            TrialData(measured=np.asarray(m, np.float32), inputs=np.asarray(i, np.float32),
                      true=np.asarray(t, np.float32), noisy=np.asarray(n, np.float32))
            for m, i, t, n in zip(meta["trial_measured"], meta["trial_inputs"],
                                  meta["trial_true"], noisy)
        ]
        tmpl = {"cost": np.zeros(0), "std": np.zeros(0),
                "p_states": np.zeros(0), "p_inputs": np.zeros(0)}
        logs, _ = ckpt.load(path, {f"trial_log_{i}": tmpl
                                   for i in range(int(meta["num_trial_logs"]))})
        self.trial_logs = []
        for i, sc in enumerate(meta["trial_log_scalars"]):
            lg = logs[f"trial_log_{i}"]
            rc = sc.get("restart_costs")
            self.trial_logs.append(TrialLog(
                cost_history=np.asarray(lg["cost"], np.float32),
                std_history=np.asarray(lg["std"], np.float32),
                steps_done=int(sc["steps_done"]),
                particles_states=lg["p_states"],
                particles_inputs=lg["p_inputs"],
                reinit_count=int(sc["reinit_count"]),
                wall_clock_s=float(sc["wall_clock_s"]),
                restart_costs=None if rc is None else np.asarray(rc, np.float32),
                restart_winner=sc.get("restart_winner"),
            ))
        self.posterior = self._build_posterior(self._padded_data())
