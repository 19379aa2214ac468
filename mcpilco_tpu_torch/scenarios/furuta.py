"""Furuta-pendulum swing-up with a semiparametric dynamics model.

The config values of ``mcpilco_tpu/scenarios/furuta.py``: each of the two
velocity-delta GP heads has a Sum(SE over the 5 raw state/input dims, Linear
over the 7 physics features) kernel on the 12-dim input of
:class:`~..models.dynamics.FurutaSemiparametric` (``semiparametric=False``:
SE over all 12 dims, which runs the fused kernels on the card), exact GP
with output normalization, 400 particles, a 150-step horizon at 50 Hz, a
saturated distance cost on [|theta_v| -> pi, theta_h -> 0], and the
rollout's ``delta_cap`` of 3 (the Linear member's mean and variance grow
with ||features||^2 off the data).  The plant is the QUBE-Servo-2-like
``furuta_qube`` ODE (voltage input, u_max 3 V).

State [theta_h, theta_v, dtheta_h, dtheta_v]; the swing-up target is
|theta_v| = pi with the arm near home.
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
from ..envs.plants import ODEPlant
from ..models import kernels as K
from ..models.costs import SaturatedDistance
from ..models.dynamics import FurutaSemiparametric
from ..models.gp import MultiGP
from ..models.policies import RandomExploration, SumOfGaussiansWithAngles
from ..utils import prng


@dataclasses.dataclass(frozen=True)
class FurutaConfig:
    seed: int = 1
    dt: float = 0.02
    T_exploration: float = 3.0
    T_control: float = 3.0
    u_max: float = 3.0  # motor voltage limit (V)
    std_noise: float = 1e-3
    num_basis: int = 200
    num_particles: int = 400
    # policy-input normalization (dth_h, dth_v, cos/sin of both angles)
    scale_factor: tuple = (15.0, 30.0, 1.0, 1.0, 1.0, 1.0)
    num_trials: int = 6
    opt_steps: tuple = (2000, 4000, 4000, 4000, 4000, 4000)
    gp_epochs: int = 1501
    semiparametric: bool = True
    # policy-init restarts per trial (PolicyOptimizer.num_restarts); False:
    # the restart lanes run one after another instead of lane-batched
    num_restarts: int = 1
    restart_vmap: bool = True
    log_dir: Optional[str] = None

    def smoke(self) -> "FurutaConfig":
        return dataclasses.replace(
            self, num_trials=1, num_basis=40, num_particles=50, opt_steps=(60,), gp_epochs=300
        )


def policy_init(cfg: FurutaConfig, policy, key, device):
    """Per-seed policy init: centers uniform over the normalized feature
    range [-1, 1], weights uniform in +-u_max/2, unit lengthscales."""
    kc = prng.fold(prng.stream(key, prng.STREAM_POLICY_INIT), 0xC0)
    gen = prng.generator(kc, device)
    opts = dict(dtype=torch.float32, device=device)
    centers = 2.0 * (torch.rand((cfg.num_basis, 6), generator=gen, **opts) - 0.5)
    weight = cfg.u_max * (torch.rand((1, cfg.num_basis), generator=gen, **opts) - 0.5)
    return policy.init_params(kc, lengthscales=torch.ones(6), centers=centers, weight=weight,
                              device=device)


def build(cfg: FurutaConfig, device="cuda") -> tuple:
    """Returns (MCPilco, reinforce_kwargs) with every tensor on ``device``."""
    disable_tf32()
    device = torch.device(device)
    key = prng.root_key(cfg.seed)
    model = FurutaSemiparametric(
        state_dim=4, input_dim=1, dt=cfg.dt, vel_indices=(2, 3), pos_indices=(0, 1)
    )
    d = model.gp_input_dim
    if cfg.semiparametric:
        # SE over the raw state/input + linear over the physics features
        kern = K.Sum(members=(K.SEArd(active_dims=tuple(range(5))),
                              K.Linear(active_dims=tuple(range(5, d)), offset=False)))
    else:
        kern = K.SEArd(active_dims=tuple(range(d)))
    # normalize_outputs: velocity deltas are large and uneven across heads
    gp = MultiGP(kernel=kern, num_heads=2, normalize_outputs=True)

    policy = SumOfGaussiansWithAngles(
        feature_dim=6, input_dim=1, num_basis=cfg.num_basis, u_max=cfg.u_max,
        angle_indices=(0, 1), non_angle_indices=(2, 3),
        scale_factor=cfg.scale_factor,
        reinit_lengthscales=(1.0,) * 6,
        reinit_centers=(1.0,) * 6,  # normalized feature range
        reinit_weight=cfg.u_max,
    )
    exploration = RandomExploration(state_dim=4, input_dim=1, u_max=cfg.u_max)
    # |theta_v| makes the -pi upright as good as +pi
    cost = SaturatedDistance(
        target_state=(np.pi, 0.0), lengthscales=(2.0, 4.0), active_dims=(1, 0), abs_dims=(1,),
    )
    plant = ODEPlant(ode_name="furuta_qube", noise_std=(cfg.std_noise,) * 4, substeps=20)
    init_dist = InitialStateDistribution(kind="gaussian", mean=np.zeros(4), var=1e-6 * np.ones(4))

    # per-step deltas capped at 3x the largest training delta
    engine = RolloutEngine(model=model, gp=gp, policy=policy, delta_cap=3.0)
    optimizer = PolicyOptimizer(
        engine=engine, cost=cost, init_dist=init_dist,
        num_particles=cfg.num_particles, horizon=int(cfg.T_control / cfg.dt),
        max_opt_steps=max(cfg.opt_steps),
        # the 150-step saturated cost is flat near the swing-up threshold:
        # the monitor exits late (the JAX package's settings)
        alpha_diff_cost=0.99, min_diff_cost=0.04, num_min_diff_cost=400,
        min_step=400.0, lr_min=0.001, p_drop_reduction=0.125,
        num_restarts=cfg.num_restarts, restart_vmap=cfg.restart_vmap,
    )
    agent = MCPilco(
        dt=cfg.dt, model=model, gp=gp, policy=policy,
        exploration_policy=exploration, cost=cost, optimizer=optimizer, device=device,
        plant=plant, init_dist=init_dist, seed=cfg.seed, log_dir=cfg.log_dir,
    )
    agent.policy_params = policy_init(cfg, policy, key, device)
    agent.scenario_name = "furuta"
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
    """|theta_v| within 0.3 rad of pi over the final quarter."""
    tail = states[-(len(states) // 4):]
    return bool(np.all(np.abs(np.abs(tail[:, 1]) - np.pi) < 0.3))
