"""MC-PILCO-4PMS cart-pole: swing-up with a modeled measurement system.

The config values of ``mcpilco_tpu/scenarios/cartpole_pms.py``:

- plant: ODE cart-pole at 30 Hz, positions measured with 3e-3 noise,
  velocities not measured: estimated online by causal differences and a
  1st-order Butterworth (fc=0.5) during control, and offline by zero-phase
  filtering and central differences for the model data;
- simulated rollouts run the same measurement chain differentiably, so the
  policy trains against what it will sense;
- SE kernel, exact GP (no SOD), sum-of-sinusoids exploration, fixed
  initial state, BPTT cotangent clip 0.2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import disable_tf32
from ..control.mc_pilco import MCPilco, ModelFitOptions, PolicyOptOptions
from ..control.rollout import InitialStateDistribution, PMSSensors, RolloutEngine
from ..control.trainer import PolicyOptimizer
from ..envs.plants import PMSODEPlant
from ..models import kernels as K
from ..models.costs import CartPoleCost
from ..models.dynamics import SpeedIntegration
from ..models.gp import MultiGP
from ..models.policies import SumOfGaussiansWithAngles, SumOfSinusoids
from ..utils import prng
from . import cartpole as base


@dataclasses.dataclass(frozen=True)
class CartpolePMSConfig:
    seed: int = 1
    dt: float = 1.0 / 30.0
    T_exploration: float = 3.0
    T_control: float = 3.0
    num_trials: int = 5
    u_max: float = 10.0
    std_noise: float = 3e-3
    fc_online: float = 0.5  # online butter(1, fc) cutoff
    num_basis: int = 200
    num_particles: int = 400
    opt_steps: tuple = (2000, 4000, 4000, 4000, 4000)
    learning_rates: tuple = (0.01,) * 5
    p_dropout: tuple = (0.25,) * 5
    gp_epochs: int = 1501
    bptt_clip: float = 0.2
    # offline velocity estimator of the GP targets: "butter_cd" (the
    # reference protocol) or "savgol" (Savitzky-Golay, window 7, order 5)
    vel_est: str = "butter_cd"
    # policy-init restarts per trial (PolicyOptimizer.num_restarts); False:
    # the restart lanes run one after another instead of lane-batched
    num_restarts: int = 1
    restart_vmap: bool = True
    log_dir: Optional[str] = None

    def smoke(self) -> "CartpolePMSConfig":
        return dataclasses.replace(
            self, num_trials=1, num_basis=40, num_particles=50, opt_steps=(60,), gp_epochs=300
        )


def policy_init(cfg: CartpolePMSConfig, policy, key, device):
    """Per-seed policy init (centers of [x, xd, thd] in +-pi)."""
    return base.random_policy_params(policy, key, device, cfg.num_basis, cfg.u_max)


def build(cfg: CartpolePMSConfig, device="cuda") -> tuple:
    """Returns (MCPilco, reinforce_kwargs) with every tensor on ``device``."""
    disable_tf32()
    device = torch.device(device)
    key = prng.root_key(cfg.seed)
    model = SpeedIntegration(
        state_dim=4, input_dim=1, dt=cfg.dt,
        vel_indices=(1, 3), pos_indices=(0, 2),
        angle_indices=(2,), not_angle_indices=(0, 1, 3),
    )
    gp = MultiGP(kernel=K.SEArd(active_dims=tuple(range(6))), num_heads=2)
    policy = SumOfGaussiansWithAngles(
        feature_dim=5, input_dim=1, num_basis=cfg.num_basis, u_max=cfg.u_max,
        angle_indices=(2,), non_angle_indices=(0, 1, 3),
        reinit_lengthscales=(1.0,) * 5,
        reinit_centers=(np.pi, np.pi, np.pi, 1.0, 1.0),
        reinit_weight=cfg.u_max,
    )
    exploration = SumOfSinusoids(
        state_dim=4, input_dim=1, num_sin=10,
        omega_min=0.1 * 2 * np.pi, omega_max=2 * 2 * np.pi,
        amplitude_min=cfg.u_max / 10, amplitude_max=cfg.u_max / 10,
        dt=cfg.dt,
    )
    cost = CartPoleCost(target_state=(np.pi, 0.0), lengthscales=(3.0, 1.0))
    plant = PMSODEPlant(
        ode_name="cartpole", noise_std=(cfg.std_noise,) * 4,
        pos_indices=(0, 2), vel_indices=(1, 3), fc=cfg.fc_online,
    )
    sensors = PMSSensors(
        pos_indices=(0, 2), vel_indices=(1, 3),
        std_pos_noise=(cfg.std_noise, cfg.std_noise), fc=cfg.fc_online, dt=cfg.dt,
    )
    init_dist = InitialStateDistribution(kind="gaussian", mean=np.zeros(4), var=1e-4 * np.ones(4))

    # the finite-difference velocities (gain 1/dt = 30) make BPTT cotangents
    # explode; the per-particle cap of 0.2 is the one the JAX package's cap
    # sweep converged with
    engine = RolloutEngine(model=model, gp=gp, policy=policy, sensors=sensors,
                           bptt_clip=cfg.bptt_clip)
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
        offline_filtering=True, offline_filter_cutoff=0.5,
        offline_filter_method=cfg.vel_est,
        seed=cfg.seed, log_dir=cfg.log_dir,
        fixed_initial_state=True,
    )
    agent.policy_params = policy_init(cfg, policy, key, device)
    agent.scenario_name = "cartpole_pms"
    agent.scenario_config = cfg
    reinforce_kwargs = dict(
        num_trials=cfg.num_trials,
        T_exploration=cfg.T_exploration,
        T_control=cfg.T_control,
        model_fit_options=[ModelFitOptions(num_epochs=cfg.gp_epochs)] * max(cfg.num_trials, 1),
        policy_opt_options=[
            PolicyOptOptions(opt_steps=s, learning_rate=lr, p_dropout=p)
            for s, lr, p in zip(cfg.opt_steps, cfg.learning_rates, cfg.p_dropout)
        ],
    )
    return agent, reinforce_kwargs


swingup_success = base.swingup_success
