"""Sharded training over a device mesh: the port of ``mcpilco_tpu/parallel/shard.py``.

Two surfaces, with the JAX package's signatures and results:

- :func:`sharded_training_round`: the production path on several devices:
  the GP MLL fit (``MultiGP.fit``, replicated data) and then the policy
  optimizer (``PolicyOptimizer.optimize``: the chunked loop with its
  convergence monitor and NaN guard, captured as a CUDA graph on the card)
  with the particles sharded over ``optimizer.mesh``;
- :func:`make_sharded_train_step`: one GP MLL gradient step and one
  policy-gradient step through the sharded rollout, a small unit surface.

Every rank runs the same call on its own device (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..control.trainer import OptResult, PolicyOptimizer
from ..models.gp import GPData, GPParams, _leaves, _unflatten, tree_map
from . import mesh as mesh_mod


class TrainingRoundOut(NamedTuple):
    gp_params: GPParams
    mll_history: torch.Tensor  # [num_gp_epochs]
    opt: OptResult


def sharded_training_round(optimizer: PolicyOptimizer, gp_params: GPParams, data: GPData,
                           policy_params, key, num_gp_epochs: int = 5, gp_lr: float = 0.01,
                           num_opt_steps: int = 6, lr0: float = 0.01, p_dropout0: float = 0.0,
                           noise_fn=None, chunk=None) -> TrainingRoundOut:
    """One MC-PILCO training round through the production path on every
    rank of ``optimizer.mesh``: fit the GP hyperparameters, build the
    posterior, then optimize the policy with the particles sharded.
    ``noise_fn``, ``chunk``: see ``PolicyOptimizer.optimize``."""
    if optimizer.mesh is None:
        raise ValueError("sharded_training_round needs a PolicyOptimizer with a mesh")
    gp = optimizer.engine.gp
    gp_params, mll_hist = gp.fit(gp_params, data, num_epochs=num_gp_epochs,
                                 learning_rate=gp_lr)
    posterior = gp.fit_posterior(gp_params, data)
    opt = optimizer.optimize(key, policy_params, gp_params, posterior,
                             num_opt_steps=num_opt_steps, lr0=lr0, p_dropout0=p_dropout0,
                             noise_fn=noise_fn, chunk=chunk)
    return TrainingRoundOut(gp_params=gp_params, mll_history=mll_hist, opt=opt)


class AdamState(NamedTuple):
    m: object
    v: object
    count: torch.Tensor


def adam_init(params) -> AdamState:
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(m=zeros, v=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32))


def adam_update(grads, state: AdamState, params, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step (``mcpilco_tpu/control/trainer.py`` ``adam_update``):
    (new params, new state)."""
    count = state.count + 1
    t = count.to(torch.float32)
    m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state.v, grads)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    new = tree_map(lambda p, mm, vv: p - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps),
                   params, m, v)
    return new, AdamState(m=m, v=v, count=count)


class ShardedStepOut(NamedTuple):
    policy_params: object
    adam: AdamState
    gp_params: GPParams
    cost: torch.Tensor
    mll: torch.Tensor


def make_sharded_train_step(optimizer: PolicyOptimizer, mesh, gp_lr: float = 0.01):
    """``step(policy_params, adam, gp_params, gp_adam, data, posterior, key,
    lr, p_drop) -> ShardedStepOut`` with the particles sharded over the
    mesh's particle axis: the initial particles and the rollout's noise are
    drawn on the full logical shape from ``key`` and sliced; the cost and
    the policy gradient are summed over ``"p"``."""
    engine = optimizer.engine
    gp = engine.gp
    sharded = dataclasses.replace(optimizer, mesh=mesh)

    def step(policy_params, adam, gp_params, gp_adam, data: GPData, posterior, key, lr, p_drop):
        policy_params, gp_params, posterior = mesh_mod.replicate(
            mesh, (policy_params, gp_params, posterior))
        dev = posterior.x_tr.device

        # GP MLL step (heads batched; data replicated)
        leaves = [t.detach().requires_grad_(True) for t in _leaves(gp_params)]
        mll = gp.mll(_unflatten(gp_params, leaves), data)
        gp_grads = [torch.zeros_like(t) if g is None else g
                    for t, g in zip(leaves, torch.autograd.grad(mll, leaves, allow_unused=True))]
        with torch.no_grad():
            new_gp, gp_adam = adam_update(_unflatten(gp_params, gp_grads), gp_adam, gp_params,
                                          gp_lr)

        # policy-gradient step through the sharded particle rollout
        noise = sharded._shard_noise(engine.draw_noise(
            key, optimizer.num_particles, optimizer.horizon, float(p_drop), dev,
            init_dist=optimizer.init_dist), lanes=False)
        params = {k: v.detach().requires_grad_(True) for k, v in policy_params.items()}
        s0 = optimizer.init_dist.sample(None, noise.init.shape[0], dev, eps=noise.init,
                                        idx=noise.init_idx)
        res = engine.simulate(None, params, gp_params, posterior, s0, optimizer.horizon,
                              p_dropout=float(p_drop), noise=noise)
        cost, _ = optimizer.cost(res.states, res.inputs, 0, group=sharded._particle_group())
        names = list(params)
        grads = torch.autograd.grad(cost, [params[k] for k in names])
        grads = {k: mesh_mod.psum_(mesh, g.contiguous(), mesh_mod.PARTICLE_AXIS)
                 for k, g in zip(names, grads)}
        mask = engine.policy.param_mask(policy_params)
        grads = {k: g if mask[k] else torch.zeros_like(g) for k, g in grads.items()}
        with torch.no_grad():
            new_policy, adam = adam_update(grads, adam, {k: v.detach() for k, v in
                                                         policy_params.items()}, lr)
        return ShardedStepOut(policy_params=new_policy, adam=adam, gp_params=new_gp,
                              cost=cost.detach(), mll=mll.detach())

    return step
