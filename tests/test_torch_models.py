"""The port's dynamics model, policies and cost against the JAX package, in
float64 (rtol 1e-9: the two differ only by summation order).  Random draws
are made on the JAX side and handed to the port (the dropout keep-mask, the
next-state normals), since the two frameworks' generators differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpilco_tpu.models import costs as jcosts
from mcpilco_tpu.models import dynamics as jdyn
from mcpilco_tpu.models import policies as jpol
from mcpilco_tpu_torch.models import costs as tcosts
from mcpilco_tpu_torch.models import dynamics as tdyn
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.utils import prng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

GOLD = dict(rtol=1e-9, atol=1e-12)
MODEL = dict(state_dim=4, input_dim=1, dt=0.05, vel_indices=(1, 3), pos_indices=(0, 2),
             angle_indices=(2,), not_angle_indices=(0, 1, 3))
POLICY = dict(feature_dim=5, input_dim=1, num_basis=12, u_max=10.0, angle_indices=(2,),
              non_angle_indices=(0, 1, 3), reinit_lengthscales=(1.0,) * 5,
              reinit_centers=(np.pi, np.pi, np.pi, 1.0, 1.0), reinit_weight=10.0)


def test_speed_integration(x64):
    rng = np.random.default_rng(0)
    jm, tm = jdyn.SpeedIntegration(**MODEL), tdyn.SpeedIntegration(**MODEL)
    states, inputs = rng.standard_normal((20, 4)), rng.standard_normal((20, 1))
    xj, yj = jm.training_pairs(jnp.asarray(states), jnp.asarray(inputs))
    xt, yt = tm.training_pairs(torch.as_tensor(states), torch.as_tensor(inputs))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **GOLD)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **GOLD)
    assert tm.gp_input_dim == jm.gp_input_dim == 6 and tm.num_heads == 2

    s, u = rng.standard_normal((7, 4)), rng.standard_normal((7, 1))
    mean, var = rng.standard_normal((2, 7)), rng.uniform(0.0, 0.1, (2, 7))
    key = jax.random.PRNGKey(3)
    eps = jax.random.normal(key, (7, 2), jnp.float64)
    nj, mj, vj = jm.sample_next_state(*map(jnp.asarray, (s, u, mean, var)), key)
    nt, mt, vt = tm.sample_next_state(*map(torch.as_tensor, (s, u, mean, var)),
                                      eps=torch.tensor(np.asarray(eps)))
    for a, b in ((nt, nj), (mt, mj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GOLD)
    nj0, _, _ = jm.sample_next_state(*map(jnp.asarray, (s, u, mean, var)), key,
                                     particle_pred=False)
    nt0, _, _ = tm.sample_next_state(*map(torch.as_tensor, (s, u, mean, var)),
                                     particle_pred=False)
    np.testing.assert_allclose(nt0.numpy(), np.asarray(nj0), **GOLD)


@pytest.mark.parametrize("p_dropout", [0.0, 0.25])
def test_sum_of_gaussians_with_angles(x64, p_dropout):
    jp, tp = jpol.SumOfGaussiansWithAngles(**POLICY), tpol.SumOfGaussiansWithAngles(**POLICY)
    params = jp.init_params(jax.random.PRNGKey(1), dtype=jnp.float64)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape, x.dtype), params)
    states = np.random.default_rng(1).standard_normal((9, 4)) * 2.0
    key = jax.random.PRNGKey(5)
    uj = jax.jit(lambda p, s: jp.apply(p, s, 3, key=key, p_dropout=p_dropout))(
        params, jnp.asarray(states))
    # the JAX draw, reproduced and handed to the port as its keep-mask
    keep = jax.random.bernoulli(key, max(1.0 - p_dropout, 1e-6), (9, POLICY["num_basis"]))
    tparams = to_torch(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ut = tp.apply(tparams, torch.as_tensor(states), 3, p_dropout=p_dropout,
                  keep=torch.tensor(np.asarray(keep)))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **GOLD)

    # gradients w.r.t. every leaf and the states
    def loss_j(p, s):
        return jnp.sum(jp.apply(p, s, 3, key=key, p_dropout=p_dropout) ** 2)

    gj_p, gj_s = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(params, jnp.asarray(states))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    st = torch.as_tensor(states).requires_grad_(True)
    out = tp.apply(leaves, st, 3, p_dropout=p_dropout, keep=torch.tensor(np.asarray(keep)))
    g = torch.autograd.grad(torch.sum(out**2), [*leaves.values(), st])
    for (name, gt) in zip(leaves, g):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj_p[name]), **GOLD, err_msg=name)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(gj_s), **GOLD)


def test_policy_reinit_and_exploration():
    tp = tpol.SumOfGaussiansWithAngles(**POLICY)
    params = tp.init_params(prng.root_key(0))
    new = tp.reinit(params, prng.fold(prng.root_key(0), 1))
    assert new["centers"].shape == (12, 5) and new["weight"].shape == (1, 12)
    assert torch.all(new["centers"].abs() <= torch.tensor([np.pi] * 3 + [1.0] * 2))
    assert torch.all(new["weight"].abs() <= 5.0)
    torch.testing.assert_close(new["log_lengthscales"], torch.zeros(5))
    again = tp.reinit(params, prng.fold(prng.root_key(0), 1))
    torch.testing.assert_close(again["centers"], new["centers"])  # a pure function of the key

    expl = tpol.RandomExploration(state_dim=4, input_dim=1, u_max=10.0)
    u = torch.stack([expl.apply({}, torch.zeros(1, 4), t, key=prng.root_key(2))[0]
                     for t in range(200)])
    assert u.shape == (200, 1) and torch.all(u.abs() < 10.0)
    assert u.std() > 3.0  # spread over the range, not constant


def test_cartpole_cost_and_expected_cost(x64):
    kw = dict(target_state=(np.pi, 0.0), lengthscales=(3.0, 1.0), angle_index=2, pos_index=0)
    jc, tc = jcosts.CartPoleCost(**kw), tcosts.CartPoleCost(**kw)
    states = np.random.default_rng(2).standard_normal((10, 8, 4)) * 2.0
    inputs = np.zeros((10, 8, 1))
    cj, sj = jc(jnp.asarray(states), jnp.asarray(inputs))
    st = torch.as_tensor(states).requires_grad_(True)
    ct, s_t = tc(st, torch.as_tensor(inputs))
    np.testing.assert_allclose(float(ct.detach()), float(cj), **GOLD)
    np.testing.assert_allclose(float(s_t), float(sj), **GOLD)
    assert not s_t.requires_grad  # the particle std is detached
    gj = jax.grad(lambda s: jc(s, jnp.asarray(inputs))[0])(jnp.asarray(states))
    (gt,) = torch.autograd.grad(ct, st)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GOLD)
