"""MuJoCo cart-pole swing-up.

The config values of ``mcpilco_tpu/scenarios/cartpole_mujoco.py``: the
state layout is [x, theta, xd, thd] with theta = 0 at the upright target
and pi hanging (the start), u_max 2.5, simulation timestep 0.01 s, control
at 20 Hz; SE+P(2) over the 6-dim GP input when the fit has >= 1000 epochs
(else SE), SOD relative 0.5, 400 particles, optional delta cap, restart
lanes and a per-trial cost-lengthscale curriculum.  The plant is
``envs/assets/cartpole_swingup.xml`` in MuJoCo, on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import disable_tf32
from ..control.mc_pilco import MCPilco, ModelFitOptions, PolicyOptOptions
from ..control.rollout import InitialStateDistribution, RolloutEngine
from ..control.trainer import PolicyOptimizer
from ..envs.mujoco_plant import MujocoPlant
from ..models import kernels as K
from ..models import sod as sod_mod
from ..models.costs import CartPoleCost
from ..models.dynamics import SpeedIntegration
from ..models.gp import MultiGP
from ..models.policies import RandomExploration, SumOfGaussiansWithAngles
from ..utils import prng


@dataclasses.dataclass(frozen=True)
class CartpoleMujocoConfig:
    seed: int = 1
    dt: float = 0.05
    sim_timestep: float = 0.01
    T_exploration: float = 3.0
    T_control: float = 3.0
    num_trials: int = 5
    u_max: float = 2.5
    std_noise: float = 1e-2
    num_basis: int = 200
    num_particles: int = 400
    opt_steps: tuple = (2000, 4000, 4000, 4000, 4000)
    gp_epochs: int = 1501
    use_sod: bool = True
    # cap on the per-step deltas in units of the largest training delta
    # (needs output normalization, which it turns on); None: unbounded
    delta_cap: Optional[float] = None
    # policy-init restarts per trial; False: the lanes one after another
    num_restarts: int = 1
    restart_vmap: bool = True
    # "fixed": (3.0, 1.0); "curriculum": (6.0, 2.0) at trial 0, then (3.0, 1.0)
    cost_lengthscales: str = "fixed"
    log_dir: Optional[str] = None

    def smoke(self) -> "CartpoleMujocoConfig":
        return dataclasses.replace(
            self, num_trials=1, num_basis=40, num_particles=50, opt_steps=(60,), gp_epochs=300
        )


def policy_init(cfg: CartpoleMujocoConfig, policy, key, device):
    """Per-seed policy init with the MuJoCo center ranges: angle centers in
    +-1.5 pi (as cos/sin), [x, xd, thd] centers in [+-2, +-2, +-2 pi],
    weights uniform in +-u_max/2, unit lengthscales."""
    kc = prng.fold(prng.stream(key, prng.STREAM_POLICY_INIT), 0xC0)
    gen = prng.generator(kc, device)
    opts = dict(dtype=torch.float32, device=device)
    uniform = lambda *shape: torch.rand(shape, generator=gen, **opts)
    angle_centers = 1.5 * np.pi * 2 * (uniform(cfg.num_basis, 1) - 0.5)
    not_angle_scale = torch.tensor([2.0, 2.0, 2.0 * np.pi], **opts)
    centers = torch.cat([not_angle_scale * 2 * (uniform(cfg.num_basis, 3) - 0.5),
                         torch.cos(angle_centers), torch.sin(angle_centers)], dim=1)
    weight = cfg.u_max * (uniform(1, cfg.num_basis) - 0.5)
    return policy.init_params(kc, lengthscales=torch.ones(5), centers=centers, weight=weight,
                              device=device)


def build(cfg: CartpoleMujocoConfig, device="cuda") -> tuple:
    """Returns (MCPilco, reinforce_kwargs) with every tensor on ``device``.
    The MuJoCo plant needs ``mujoco`` only when it runs."""
    disable_tf32()
    device = torch.device(device)
    key = prng.root_key(cfg.seed)
    # mujoco layout: [x, theta, xd, thd]
    model = SpeedIntegration(
        state_dim=4, input_dim=1, dt=cfg.dt,
        vel_indices=(2, 3), pos_indices=(0, 1),
        angle_indices=(1,), not_angle_indices=(0, 2, 3),
    )
    kern = (
        K.se_plus_volterra(active_dims=tuple(range(6)), degree=2)
        if cfg.gp_epochs >= 1000
        else K.SEArd(active_dims=tuple(range(6)))
    )
    gp = MultiGP(kernel=kern, num_heads=2, normalize_outputs=cfg.delta_cap is not None)
    policy = SumOfGaussiansWithAngles(
        feature_dim=5, input_dim=1, num_basis=cfg.num_basis, u_max=cfg.u_max,
        angle_indices=(1,), non_angle_indices=(0, 2, 3),
        reinit_lengthscales=(1.0,) * 5,
        reinit_centers=(np.pi, np.pi, np.pi, 1.0, 1.0),
        reinit_weight=cfg.u_max,
    )
    exploration = RandomExploration(state_dim=4, input_dim=1, u_max=cfg.u_max)
    if cfg.cost_lengthscales == "curriculum":
        # trials past the schedule clamp to its last row
        cost_ls, per_trial = np.array([[6.0, 2.0], [3.0, 1.0]]), True
    elif cfg.cost_lengthscales == "fixed":
        cost_ls, per_trial = np.array([3.0, 1.0]), False
    else:
        raise ValueError(f"unknown cost_lengthscales {cfg.cost_lengthscales!r}")
    cost = CartPoleCost(
        target_state=(0.0, 0.0), lengthscales=cost_ls, per_trial=per_trial,
        angle_index=1, pos_index=0,
    )
    plant = MujocoPlant(
        xml="cartpole_swingup.xml", noise_std=(cfg.std_noise,) * 4, sim_timestep=cfg.sim_timestep
    )
    init_dist = InitialStateDistribution(
        kind="gaussian", mean=np.array([0.0, np.pi, 0.0, 0.0]), var=1e-4 * np.ones(4)
    )
    engine = RolloutEngine(model=model, gp=gp, policy=policy, delta_cap=cfg.delta_cap)
    optimizer = PolicyOptimizer(
        engine=engine, cost=cost, init_dist=init_dist,
        num_particles=cfg.num_particles, horizon=int(cfg.T_control / cfg.dt),
        max_opt_steps=max(cfg.opt_steps),
        alpha_diff_cost=0.99, min_diff_cost=0.08, num_min_diff_cost=200,
        min_step=200.0, lr_min=0.0025, p_drop_reduction=0.125,
        num_restarts=cfg.num_restarts, restart_vmap=cfg.restart_vmap,
    )
    agent = MCPilco(
        dt=cfg.dt, model=model, gp=gp, policy=policy,
        exploration_policy=exploration, cost=cost, optimizer=optimizer, device=device,
        plant=plant, init_dist=init_dist,
        sod=sod_mod.SODConfig(threshold_mode="relative", threshold=(0.5,)) if cfg.use_sod else None,
        seed=cfg.seed, log_dir=cfg.log_dir,
    )
    agent.policy_params = policy_init(cfg, policy, key, device)
    agent.scenario_name = "cartpole_mujoco"
    agent.scenario_config = cfg
    reinforce_kwargs = dict(
        num_trials=cfg.num_trials,
        T_exploration=cfg.T_exploration,
        T_control=cfg.T_control,
        model_fit_options=[ModelFitOptions(num_epochs=cfg.gp_epochs)] * max(cfg.num_trials, 1),
        policy_opt_options=[
            PolicyOptOptions(opt_steps=s, learning_rate=0.01, p_dropout=0.25)
            for s in cfg.opt_steps
        ],
    )
    return agent, reinforce_kwargs


def swingup_success(states: np.ndarray) -> bool:
    """MuJoCo layout: angle index 1, upright target 0; |wrapped theta| < 0.25
    and |x| < 0.5 over the final quarter."""
    tail = states[-(len(states) // 4):]
    wrapped = np.abs((tail[:, 1] + np.pi) % (2 * np.pi) - np.pi)
    return bool(np.all(wrapped < 0.25) and np.all(np.abs(tail[:, 0]) < 0.5))
