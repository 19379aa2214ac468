"""Cart-pole swing-up: the flagship scenario.

:func:`build` returns a ready :class:`~..control.mc_pilco.MCPilco` and the
``reinforce`` kwargs, with the config values of
``mcpilco_tpu/scenarios/cartpole.py`` (SE+P(2) kernel, SOD relative 0.5,
400 particles, 5 trials x 3 s at 20 Hz, u_max 10).  ``multi_init=True`` is
the multi-init variant: a bimodal initial distribution at x = +-1 m and
wider policy centers.  The state is [x, x_dot, theta, theta_dot]; the
swing-up target is |theta| = pi, x = 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import disable_tf32
from ..control.mc_pilco import MCPilco, ModelFitOptions, PolicyOptOptions
from ..control.rollout import InitialStateDistribution, RolloutEngine
from ..control.trainer import PolicyOptimizer
from ..envs.plants import ODEPlant
from ..models import kernels as K
from ..models import sod as sod_mod
from ..models.costs import CartPoleCost
from ..models.dynamics import SpeedIntegration
from ..models.gp import MultiGP
from ..models.policies import RandomExploration, SumOfGaussiansWithAngles
from ..utils import prng


@dataclasses.dataclass(frozen=True)
class CartpoleConfig:
    seed: int = 1
    dt: float = 0.05
    T_exploration: float = 3.0
    T_control: float = 3.0
    num_trials: int = 5
    u_max: float = 10.0
    std_noise: float = 1e-2
    kernel: str = "se+p2"  # 'se+p2' | 'se'
    use_sod: bool = True
    num_basis: int = 200
    num_particles: int = 400
    opt_steps: tuple = (2000, 4000, 4000, 4000, 4000)
    learning_rates: tuple = (0.01,) * 5
    p_dropout: tuple = (0.25,) * 5
    p_drop_reduction: float = 0.125
    alpha_diff_cost: float = 0.99
    min_diff_cost: float = 0.08
    num_min_diff_cost: int = 200
    min_step: float = 200.0
    lr_min: float = 0.0025
    gp_epochs: int = 1501
    multi_init: bool = False
    log_dir: Optional[str] = None

    def smoke(self) -> "CartpoleConfig":
        """Tiny config for CI smoke tests (SE kernel: the polynomial part
        needs the full epoch budget to extrapolate safely)."""
        return dataclasses.replace(
            self,
            kernel="se",
            num_trials=1,
            num_basis=40,
            num_particles=50,
            opt_steps=(60,),
            gp_epochs=300,
            num_min_diff_cost=20,
            min_step=10.0,
        )


STATE_DIM = 4
INPUT_DIM = 1
GP_INPUT_DIM = 6  # [x, xd, thd, sin(th), cos(th), u]


def random_policy_params(policy, key, device, num_basis: int, u_max: float,
                         center_scale=(math.pi,) * 3):
    """Random centers over the state range and random weights: centers of
    [x, xd, thd] uniform in +-``center_scale``, of (cos th, sin th) from a
    uniform angle.  ``key`` is the scenario root key."""
    kc = prng.fold(prng.stream(key, prng.STREAM_POLICY_INIT), 0xC0)
    gen = prng.generator(kc, device)
    opts = dict(dtype=torch.float32, device=device)
    angle_centers = math.pi * 2 * (torch.rand((num_basis, 1), generator=gen, **opts) - 0.5)
    not_angle_centers = torch.as_tensor(center_scale, **opts) * 2 * (
        torch.rand((num_basis, 3), generator=gen, **opts) - 0.5)
    centers = torch.cat(
        [not_angle_centers, torch.cos(angle_centers), torch.sin(angle_centers)], dim=1
    )
    weight = u_max * (torch.rand((INPUT_DIM, num_basis), generator=gen, **opts) - 0.5)
    return policy.init_params(
        kc, lengthscales=torch.ones(STATE_DIM + 1), centers=centers, weight=weight,
        device=device,
    )


def policy_init(cfg: CartpoleConfig, policy, key, device):
    """Per-seed policy init; multi-init widens the [x, xd, thd] centers to
    [+-2, +-2, +-2 pi]."""
    scale = (2.0, 2.0, 2.0 * math.pi) if cfg.multi_init else (math.pi,) * 3
    return random_policy_params(policy, key, device, cfg.num_basis, cfg.u_max, scale)


def build(cfg: CartpoleConfig, device="cuda", mesh=None) -> tuple:
    """Returns (MCPilco, reinforce_kwargs) with every tensor on ``device``.
    ``mesh`` (a ``parallel.mesh.Mesh`` with a particle axis) shards the
    policy optimization's particles over its ranks (each on its own
    ``device``): see ``trainer.PolicyOptimizer.mesh``."""
    disable_tf32()
    device = torch.device(device)
    key = prng.root_key(cfg.seed)

    model = SpeedIntegration(
        state_dim=STATE_DIM,
        input_dim=INPUT_DIM,
        dt=cfg.dt,
        vel_indices=(1, 3),
        pos_indices=(0, 2),
        angle_indices=(2,),
        not_angle_indices=(0, 1, 3),
    )
    if cfg.kernel == "se+p2":
        kern = K.se_plus_volterra(active_dims=tuple(range(GP_INPUT_DIM)), degree=2)
    elif cfg.kernel == "se":
        kern = K.SEArd(active_dims=tuple(range(GP_INPUT_DIM)))
    else:
        raise ValueError(cfg.kernel)
    gp = MultiGP(kernel=kern, num_heads=model.num_heads)

    policy = SumOfGaussiansWithAngles(
        feature_dim=STATE_DIM + 1,
        input_dim=INPUT_DIM,
        num_basis=cfg.num_basis,
        u_max=cfg.u_max,
        angle_indices=(2,),
        non_angle_indices=(0, 1, 3),
        reinit_lengthscales=(1.0,) * (STATE_DIM + 1),
        reinit_centers=(np.pi, np.pi, np.pi, 1.0, 1.0),
        reinit_weight=cfg.u_max,
    )
    exploration = RandomExploration(state_dim=STATE_DIM, input_dim=INPUT_DIM, u_max=cfg.u_max)
    cost = CartPoleCost(
        target_state=(np.pi, 0.0), lengthscales=(3.0, 1.0), angle_index=2, pos_index=0
    )
    plant = ODEPlant(ode_name="cartpole", noise_std=(cfg.std_noise,) * STATE_DIM)
    if cfg.multi_init:
        init_dist = InitialStateDistribution(
            kind="multi_gauss", mean=[[1.0, 0.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0]],
            var=[[1e-4] * 4] * 2,
        )
    else:
        init_dist = InitialStateDistribution(kind="gaussian", mean=np.zeros(4),
                                             var=1e-4 * np.ones(4))

    engine = RolloutEngine(model=model, gp=gp, policy=policy)
    optimizer = PolicyOptimizer(
        engine=engine,
        cost=cost,
        init_dist=init_dist,
        num_particles=cfg.num_particles,
        horizon=int(cfg.T_control / cfg.dt),
        max_opt_steps=max(cfg.opt_steps),
        alpha_diff_cost=cfg.alpha_diff_cost,
        min_diff_cost=cfg.min_diff_cost,
        num_min_diff_cost=cfg.num_min_diff_cost,
        min_step=cfg.min_step,
        lr_min=cfg.lr_min,
        p_drop_reduction=cfg.p_drop_reduction,
    )
    agent = MCPilco(
        dt=cfg.dt,
        model=model,
        gp=gp,
        policy=policy,
        exploration_policy=exploration,
        cost=cost,
        optimizer=optimizer,
        device=device,
        plant=plant,
        init_dist=init_dist,
        sod=sod_mod.SODConfig(threshold_mode="relative", threshold=(0.5,)) if cfg.use_sod else None,
        seed=cfg.seed,
        log_dir=cfg.log_dir,
        mesh=mesh,
    )
    agent.policy_params = policy_init(cfg, policy, key, device)
    agent.scenario_name = "cartpole"
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


def swingup_success(states: np.ndarray, angle_index: int = 2, pos_index: int = 0) -> bool:
    """Success oracle: |theta| within 0.25 rad of pi and |x| < 0.5 m over the
    final quarter of the trajectory, on either side."""
    tail = states[-(len(states) // 4):]
    th_ok = np.abs(np.abs(tail[:, angle_index]) - np.pi) < 0.25
    x_ok = np.abs(tail[:, pos_index]) < 0.5
    return bool(np.all(th_ok & x_ok))
