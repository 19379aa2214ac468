"""UR5 joint-space trajectory tracking.

The config values of ``mcpilco_tpu/scenarios/ur5.py``: 12-dim state
[q(6), qd(6)], 6 torque inputs, a speed-integration model whose 6 GP heads
(outputs normalized) take a 24-dim input (cos/sin of the 6 angles, the 6
velocities, the 6 torques) through an SE + Volterra-MPK kernel of degree
``poly_degree`` (default 1: Sum(SE, MPK1), which has no fused kernel and
predicts through the plain ops on the card; 2: the 'se+p2' structure of
K1/K2), SOD with an absolute threshold of 1e-3 per head, PD exploration
along the target trajectory, a 400-basis tracking policy over [s, target(t)
- s], the saturated tracking cost, and 200 particles x 200 steps of BPTT
with each step rematerialized in the backward pass, the cotangents clipped
at 1 and the predicted deltas capped at 3x the largest training delta.

The plant is the mesh-free arm ``envs/assets/ur5.xml`` in MuJoCo, on the
host.  :func:`record_ur5_trials` writes two PD-exploration trials of it to
``envs/assets/ur5_pd_trials.npz``, which drive the model side where
``mujoco`` is absent (``MCPilco.add_external_trial``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import disable_tf32
from ..control.mc_pilco import MCPilco, ModelFitOptions, PolicyOptOptions
from ..control.rollout import InitialStateDistribution, RolloutEngine
from ..control.trainer import PolicyOptimizer
from ..envs.mujoco_plant import ASSETS, MujocoPlant
from ..envs.trajectories import reference_file, ur5_joint_trajectory, ur5_reference_trajectory
from ..models import kernels as K
from ..models import sod as sod_mod
from ..models.costs import SaturatedTrajectoryTracking
from ..models.dynamics import SpeedIntegration
from ..models.gp import MultiGP
from ..models.policies import PDController, SumOfGaussiansTracking
from ..utils import prng

TRIALS_ASSET = os.path.join(ASSETS, "ur5_pd_trials.npz")


@dataclasses.dataclass(frozen=True)
class UR5Config:
    """The JAX package's fields and defaults, every one of them: a checkpoint
    stores the config, and a resume in either package compares it."""

    seed: int = 1
    dt: float = 0.02
    sim_timestep: float = 0.001
    T_control: float = 4.0
    num_trials: int = 2
    std_noise: float = 1e-3
    num_basis: int = 400
    num_particles: int = 200
    opt_steps: tuple = (5000, 5000)
    gp_epochs: int = 2001
    # unused by build() in both packages: the generated trajectory keeps its
    # default amplitude 0.6
    traj_amplitude: float = 0.6
    # "generated": the quintic multi-sine; "reference": the original task's
    # recorded CSV (envs/trajectories.ur5_reference_trajectory)
    trajectory: str = "generated"
    # "approx": the mesh-free arm envs/assets/ur5.xml; "reference": the
    # original task's UR5.xml and meshes under $MCPILCO_REFERENCE
    plant: str = "approx"
    poly_degree: int = 1
    # "fixed": [0.5 x6, 1.0 x6]; "curriculum": per-trial [2, 4] -> [0.5, 1]
    cost_lengthscales: str = "fixed"
    # policy weights uniform in +-weight_init_scale
    weight_init_scale: float = 0.02
    # when trial 0 ends with its cost above plateau_rescue_frac x horizon
    # (the saturated cost's flat region), scripts/train_ur5 restarts once
    # with the cost-lengthscale curriculum
    plateau_rescue: bool = True
    plateau_rescue_frac: float = 0.9
    # rollout delta clamp in units of the max-abs training delta; None disables
    delta_cap: Optional[float] = 3.0
    log_dir: Optional[str] = None

    def smoke(self) -> "UR5Config":
        return dataclasses.replace(
            self,
            num_trials=1,
            num_basis=60,
            num_particles=30,
            opt_steps=(40,),
            gp_epochs=200,
            T_control=1.0,
        )


STATE_DIM, INPUT_DIM = 12, 6
U_MAX = (1.0,) * 6


def _plant_xml(cfg: UR5Config) -> str:
    if cfg.plant == "approx":
        return "ur5.xml"
    if cfg.plant != "reference":
        raise ValueError(f"unknown plant {cfg.plant!r}")
    return reference_file("envs", "assets", "UR5.xml", what="plant='reference' (with its meshes)")


def policy_init(cfg: UR5Config, policy, key, device):
    """The scripted policy init: centers uniform in +-pi/2 over the 12 state
    features and +-0.1 over the 12 tracking errors, weights uniform in
    +-weight_init_scale, lengthscales pi."""
    kc = prng.fold(prng.stream(key, prng.STREAM_POLICY_INIT), 0xC0)
    gen = prng.generator(kc, device)
    opts = dict(dtype=torch.float32, device=device)
    uniform = lambda *shape: torch.rand(shape, generator=gen, **opts)
    centers = torch.cat([np.pi / 2 * 2 * (uniform(cfg.num_basis, 12) - 0.5),
                         0.1 * 2 * (uniform(cfg.num_basis, 12) - 0.5)], dim=1)
    weight = cfg.weight_init_scale * 2.0 * (uniform(INPUT_DIM, cfg.num_basis) - 0.5)
    return policy.init_params(kc, lengthscales=np.pi * torch.ones(24), centers=centers,
                              weight=weight, device=device)


def build(cfg: UR5Config, device="cuda") -> tuple:
    """Returns (MCPilco, reinforce_kwargs) with every tensor on ``device``.
    The MuJoCo plant is constructed here and needs ``mujoco`` only when it
    runs."""
    disable_tf32()
    device = torch.device(device)
    key = prng.root_key(cfg.seed)
    num_steps = int(cfg.T_control / cfg.dt)
    if cfg.trajectory == "reference":
        target_traj = ur5_reference_trajectory(num_steps=num_steps, dt=cfg.dt)
    elif cfg.trajectory == "generated":
        target_traj = ur5_joint_trajectory(num_steps=num_steps, dt=cfg.dt)
    else:
        raise ValueError(f"unknown trajectory {cfg.trajectory!r}")

    model = SpeedIntegration(
        state_dim=STATE_DIM, input_dim=INPUT_DIM, dt=cfg.dt,
        vel_indices=tuple(range(6, 12)), pos_indices=tuple(range(6)),
        angle_indices=tuple(range(6)), not_angle_indices=tuple(range(6, 12)),
    )
    assert model.gp_input_dim == 24
    # normalize_outputs: the six velocity-delta heads differ in scale
    gp = MultiGP(
        kernel=K.se_plus_volterra(active_dims=tuple(range(24)), degree=cfg.poly_degree),
        num_heads=6,
        normalize_outputs=True,
    )
    policy = SumOfGaussiansTracking(
        feature_dim=2 * STATE_DIM, input_dim=INPUT_DIM, num_basis=cfg.num_basis,
        u_max=U_MAX, target_traj=target_traj,
        reinit_lengthscales=(np.pi,) * 24,
        reinit_centers=tuple([np.pi / 2] * 12 + [0.1] * 12),
        reinit_weight=1.0,
    )
    exploration = PDController(
        state_dim=STATE_DIM, input_dim=INPUT_DIM, target_traj=target_traj, u_max=U_MAX,
        noise_std=0.05,
    )
    if cfg.cost_lengthscales == "curriculum":
        cost_ls, per_trial = np.array([[2.0] * 6 + [4.0] * 6, [0.5] * 6 + [1.0] * 6]), True
    elif cfg.cost_lengthscales == "fixed":
        cost_ls, per_trial = np.array([0.5] * 6 + [1.0] * 6), False
    else:
        raise ValueError(f"unknown cost_lengthscales {cfg.cost_lengthscales!r}")
    cost = SaturatedTrajectoryTracking(
        target_traj=target_traj, lengthscales=cost_ls, per_trial=per_trial,
        used_indices=tuple(range(12)),
    )
    plant = MujocoPlant(
        xml=_plant_xml(cfg), noise_std=(cfg.std_noise,) * STATE_DIM, sim_timestep=cfg.sim_timestep
    )
    init_dist = InitialStateDistribution(
        kind="gaussian", mean=target_traj[0], var=1e-6 * np.ones(STATE_DIM)
    )
    # 200-step BPTT: each step recomputed in the backward pass, cotangents
    # clipped; deltas capped where the particles leave the data
    engine = RolloutEngine(
        model=model, gp=gp, policy=policy, remat=True, bptt_clip=1.0, delta_cap=cfg.delta_cap,
    )
    optimizer = PolicyOptimizer(
        engine=engine, cost=cost, init_dist=init_dist,
        num_particles=cfg.num_particles, horizon=num_steps,
        max_opt_steps=max(cfg.opt_steps),
        alpha_diff_cost=0.99, min_diff_cost=0.04, num_min_diff_cost=400,
        min_step=400.0, lr_min=0.0025, p_drop_reduction=0.125,
        chunk_steps=100,
    )
    agent = MCPilco(
        dt=cfg.dt, model=model, gp=gp, policy=policy,
        exploration_policy=exploration, cost=cost, optimizer=optimizer, device=device,
        plant=plant, init_dist=init_dist,
        sod=sod_mod.SODConfig(threshold_mode="absolute", threshold=(1e-3,) * 6),
        seed=cfg.seed, log_dir=cfg.log_dir,
    )
    agent.policy_params = policy_init(cfg, policy, key, device)
    agent.expl_params = exploration.init_params(
        None, sqrt_kp=np.ones(6), sqrt_kd=0.1 * np.ones(6), device=device
    )
    agent.scenario_name = "ur5"
    agent.scenario_config = cfg
    reinforce_kwargs = dict(
        num_trials=cfg.num_trials,
        T_exploration=cfg.T_control,
        T_control=cfg.T_control,
        model_fit_options=[ModelFitOptions(num_epochs=cfg.gp_epochs)] * max(cfg.num_trials, 1),
        policy_opt_options=[
            PolicyOptOptions(opt_steps=s, learning_rate=0.01, p_dropout=0.25)
            for s in cfg.opt_steps
        ],
    )
    return agent, reinforce_kwargs


def tracking_error_deg(agent) -> np.ndarray:
    """Per-joint RMS tracking error in degrees on the final trial."""
    final = agent.trials[-1]
    num_steps = min(final.true.shape[0], len(agent.cost.target_traj))
    traj = np.asarray(agent.cost.target_traj)[:num_steps, :6]
    err = final.true[:num_steps, :6] - traj
    return np.sqrt((err**2).mean(axis=0)) * 180.0 / np.pi


def tracking_success(agent) -> bool:
    """Below 10 degrees RMS on every joint in the final trial."""
    return bool(np.all(tracking_error_deg(agent) < 10.0))


def record_ur5_trials(path: str = TRIALS_ASSET, num_trials: int = 2) -> dict:
    """Record ``num_trials`` PD-exploration trials of ``UR5Config(seed=1)`` on
    the approximate arm with this package's MuJoCo plant on the CPU, and
    write their ``measured``, ``inputs`` and ``true`` arrays, stacked over
    the trials, to ``path``.  Needs ``mujoco``.  Returns the arrays."""
    cfg = UR5Config(seed=1)
    agent, _ = build(cfg, "cpu")
    trials = [agent.collect(cfg.T_control, trial_index=i, exploration=True)
              for i in range(num_trials)]
    arrays = {f: np.stack([getattr(t, f) for t in trials]) for f in ("measured", "inputs", "true")}
    np.savez_compressed(path, **arrays)
    return arrays


def recorded_trials(path: str = TRIALS_ASSET) -> dict:
    """The arrays of :func:`record_ur5_trials`'s file: ``measured`` and
    ``true`` [trials, N, 12], ``inputs`` [trials, N, 6]."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
