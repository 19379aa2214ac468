"""The Furuta semiparametric slice: the port against the JAX package.

Same numpy inputs through both packages, JAX's draws handed to the port.
Tolerances, and why:
- kernels, dynamics features, ODEs (RK4 through ``integrate``) and costs in
  float64: rtol 1e-10 (the same formulas in another order);
- the Sum(SEArd, Linear) GP on JAX-fitted parameters in float64: MLL rtol
  1e-9, posterior and predict rtol 1e-7 with atol relative to the largest
  entry (the Linear member's Gram is ill-conditioned, so LAPACK's order
  shows);
- the 10-step rollout's cost and policy gradient in float32 with the
  delta cap binding: rtol 1e-3, as the flagship slice (float32 BPTT through
  closed-loop steps of two frameworks).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_rollout_noise, padded
from mcpilco_tpu.control import rollout as jroll
from mcpilco_tpu.envs import ode as jode
from mcpilco_tpu.models import costs as jcosts
from mcpilco_tpu.models import dynamics as jdyn
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import kernels as jK
from mcpilco_tpu.models import policies as jpol
from mcpilco_tpu_torch.control import rollout as troll
from mcpilco_tpu_torch.envs import ode as tode
from mcpilco_tpu_torch.envs.plants import ODEPlant
from mcpilco_tpu_torch.models import costs as tcosts
from mcpilco_tpu_torch.models import dynamics as tdyn
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.scenarios import furuta as tfur
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

P, T, NB, G = 16, 10, 20, 2
TIGHT = dict(rtol=1e-10, atol=1e-12)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ kernels


def _kernel_pairs():
    """(name, JAX kernel, port kernel, per-head init kwargs)."""
    lin = dict(active_dims=(0, 2, 3), offset=True)
    return [
        ("linear diag+offset+mean_w", jK.Linear(**lin), tK.Linear(**lin),
         dict(sigma_diag=[0.5, 1.5, 0.8, 1.2], mean_w=[0.3, -0.2, 0.5, 0.1])),
        ("linear full_sigma", jK.Linear(active_dims=(1, 2, 3), full_sigma=True),
         tK.Linear(active_dims=(1, 2, 3), full_sigma=True),
         dict(sigma_diag=[0.7, 1.1, 0.9], free_chol=[0.3, -0.4, 0.2])),
        ("linear semi_def", jK.Linear(active_dims=(0, 1, 2), semi_def_dims=2),
         tK.Linear(active_dims=(0, 1, 2), semi_def_dims=2), dict(sigma_diag=[0.6, -0.3, 1.4])),
        ("poly", jK.Poly(base=jK.Linear(**lin), degree=3), tK.Poly(base=tK.Linear(**lin), degree=3),
         dict(sigma_diag=0.7)),
        ("product", jK.Product(members=(jK.SEArd(active_dims=(0, 1)), jK.Linear(active_dims=(2, 3)))),
         tK.Product(members=(tK.SEArd(active_dims=(0, 1)), tK.Linear(active_dims=(2, 3)))),
         dict(member_overrides=[dict(lengthscales=[0.8, 1.3], mean=0.5),
                                dict(sigma_diag=[0.9, 1.1], mean_w=[0.4, -0.6])])),
        ("scaled sign", jK.Scaled(base=jK.SEArd(active_dims=(0, 1, 2)), f_scale=jK.scale_sign,
                                  active_dims_scale=(0, 3), n_free_par=2),
         tK.Scaled(base=tK.SEArd(active_dims=(0, 1, 2)), f_scale=tK.scale_sign,
                   active_dims_scale=(0, 3), n_free_par=2),
         dict(free_par=[-1.0, -1.2], mean=0.7)),
        ("scaled sign_abs", jK.Scaled(base=jK.Linear(**lin), f_scale=jK.scale_sign_abs,
                                      active_dims_scale=(1, 2), n_pos_par=2),
         tK.Scaled(base=tK.Linear(**lin), f_scale=tK.scale_sign_abs, active_dims_scale=(1, 2),
                   n_pos_par=2),
         dict(pos_par=[0.1, 0.15], mean_w=[0.3, -0.2, 0.5, 0.1])),
        ("sum se+linear", jK.Sum(members=(jK.SEArd(active_dims=(0, 1)), jK.Linear(active_dims=(2, 3)))),
         tK.Sum(members=(tK.SEArd(active_dims=(0, 1)), tK.Linear(active_dims=(2, 3)))),
         dict(member_overrides=[dict(lengthscales=[0.8, 1.3]), dict(sigma_diag=[0.9, 1.1])])),
    ]


@pytest.mark.parametrize("case", range(len(_kernel_pairs())),
                         ids=[c[0] for c in _kernel_pairs()])
def test_kernel_gram_diag_mean_match_jax(x64, case):
    """Two heads with different parameters: the port's head-batched
    gram/diag/mean against ``jax.vmap`` of the JAX kernel over the heads."""
    _, jk, tk, kw = _kernel_pairs()[case]
    heads = [jk.init_params(dtype=jnp.float64, **kw) for _ in range(G)]
    rng = np.random.default_rng(case)
    heads[1] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(np.shape(a)), heads[1])
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *heads)
    tparams = to_torch(_np(stacked), "cpu")
    X1, X2 = rng.standard_normal((7, 4)), rng.standard_normal((5, 4))
    j1, j2 = jnp.asarray(X1), jnp.asarray(X2)
    t1, t2 = torch.as_tensor(X1)[None], torch.as_tensor(X2)[None]  # a head axis of 1
    want = {
        "gram": jax.vmap(lambda p: jk.gram(p, j1, j2))(stacked),
        "diag": jax.vmap(lambda p: jk.diag(p, j1))(stacked),
        "mean": jax.vmap(lambda p: jk.mean(p, j1))(stacked),
    }
    got = {"gram": tk.gram(tparams, t1, t2), "diag": tk.diag(tparams, t1),
           "mean": tk.mean(tparams, t1)}
    for name, w in want.items():
        g = got[name].expand(np.shape(w)).numpy()
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **TIGHT)
    assert np.abs(np.asarray(want["gram"])).max() > 1e-3  # not trivially zero
    np.testing.assert_allclose(got["diag"].expand(G, 7).numpy(),
                               np.diagonal(tk.gram(tparams, t1, t1).numpy(), axis1=-2, axis2=-1),
                               **TIGHT)
    assert jax.tree_util.tree_structure(jk.param_mask(heads[0])) == \
        jax.tree_util.tree_structure(tk.param_mask(tparams))


def test_semi_def_sigma_golden():
    """The port's ``semi_def_dims`` Sigma is the reference's
    ``diagonal_covariance_semi_def``: diag(cat([free, pos])**2), the FREE
    block first, unconstrained (a zero entry switches its feature off); the
    case of tests/test_kernels.py::TestLinearPoly::test_semi_def_sigma_golden."""
    k = tK.Linear(active_dims=(0, 1, 2), offset=False, semi_def_dims=2)
    sd = np.array([0.7, -0.0, 1.5])
    p = k.init_params(sigma_diag=np.array([0.7, 1.0, 1.5]), dtype=torch.float64)
    p = {**p, "sigma_free_diag": torch.as_tensor(sd[:2])}
    rng = np.random.default_rng(7)
    X1, X2 = rng.standard_normal((4, 3)), rng.standard_normal((5, 3))
    sigma = np.diag(np.concatenate([sd[:2], [1.5]]) ** 2)
    t1, t2 = torch.as_tensor(X1), torch.as_tensor(X2)
    np.testing.assert_allclose(k.gram(p, t1, t2).numpy(), X1 @ sigma @ X2.T, rtol=1e-12)
    np.testing.assert_allclose(k.diag(p, t1).numpy(), np.diag(X1 @ sigma @ X1.T), rtol=1e-12)
    np.testing.assert_allclose(
        k.gram(p, t1, t2).numpy(),
        X1[:, [0, 2]] @ np.diag([0.7**2, 1.5**2]) @ X2[:, [0, 2]].T, rtol=1e-12)
    assert k.param_mask(p)["sigma_free_diag"] is True
    with pytest.raises(ValueError):
        tK.Linear(active_dims=(0,), full_sigma=True, semi_def_dims=1)


@pytest.mark.parametrize("full", [False, True])
def test_linear_weight_posterior_matches_jax(x64, full):
    jk = jK.Linear(active_dims=(0, 1), full_sigma=full)
    tk = tK.Linear(active_dims=(0, 1), full_sigma=full)
    kw = dict(sigma_diag=[3.0, 2.0], **(dict(free_chol=[0.5]) if full else {}))
    heads = [jk.init_params(dtype=jnp.float64, **kw), jk.init_params(dtype=jnp.float64, **kw)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *heads)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((30, 2))
    Y = np.stack([X @ [2.0, -3.0], X @ [0.5, 1.0]]) + 0.01 * rng.standard_normal((2, 30))
    mask = (np.arange(30) < 25).astype(np.float64)
    want = jax.vmap(lambda p, y: jk.weight_posterior(p, 1e-4, jnp.asarray(X), y,
                                                     jnp.asarray(mask)))(stacked, jnp.asarray(Y))
    got = tk.weight_posterior(to_torch(_np(stacked), "cpu"), 1e-4, torch.as_tensor(X),
                              torch.as_tensor(Y), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(got.numpy(), [[2.0, -3.0], [0.5, 1.0]], atol=2e-2)


# ------------------------------------------------------------------ dynamics, ODEs, cost


def test_dynamics_features_match_jax(x64):
    rng = np.random.default_rng(4)
    states, inputs = rng.standard_normal((12, 4)), rng.standard_normal((12, 1))
    delta2, delta4 = rng.standard_normal((12, 2)), rng.standard_normal((12, 4))
    sp = dict(state_dim=4, input_dim=1, dt=0.02, vel_indices=(2, 3), pos_indices=(0, 1))
    ang = dict(state_dim=4, input_dim=1, angle_indices=(1,), not_angle_indices=(0, 2, 3))
    cases = [
        (jdyn.DeltaState(4, 1), tdyn.DeltaState(4, 1), delta4, 5),
        (jdyn.DeltaStateAngles(**ang), tdyn.DeltaStateAngles(**ang), delta4, 6),
        (jdyn.FurutaSemiparametric(**sp), tdyn.FurutaSemiparametric(**sp), delta2, 12),
    ]
    for jm, tm, delta, d_in in cases:
        assert tm.gp_input_dim == jm.gp_input_dim == d_in and tm.num_heads == jm.num_heads
        s_t, u_t = torch.as_tensor(states), torch.as_tensor(inputs)
        for got, want in (
                (tm.gp_inputs(s_t, u_t), jm.gp_inputs(jnp.asarray(states), jnp.asarray(inputs))),
                (tm.gp_targets(s_t), jm.gp_targets(jnp.asarray(states))),
                (tm.next_state(s_t, u_t, torch.as_tensor(delta)),
                 jm.next_state(jnp.asarray(states), jnp.asarray(inputs), jnp.asarray(delta)))):
            assert tuple(got.shape) == np.shape(want)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("name", ["pendulum", "furuta", "furuta_qube"])
def test_odes_through_integrate_match_jax(x64, name):
    rng = np.random.default_rng(5)
    ds = 2 if name == "pendulum" else 4
    x0 = rng.standard_normal((6, ds)) * np.array([1.0, 1.0, 5.0, 5.0][:ds])
    u = rng.uniform(-3, 3, (6, 1))
    want = jode.integrate(jode.REGISTRY[name], jnp.asarray(x0), jnp.asarray(u), 0.02, 20)
    got = tode.integrate(tode.REGISTRY[name], torch.as_tensor(x0), torch.as_tensor(u), 0.02, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    assert not np.allclose(got.numpy(), x0)


@pytest.mark.parametrize("saturated", [False, True])
def test_distance_costs_with_abs_dims_match_jax(x64, saturated):
    kw = dict(target_state=(np.pi, 0.0), lengthscales=(2.0, 4.0), active_dims=(1, 0),
              abs_dims=(1,))
    jc = (jcosts.SaturatedDistance if saturated else jcosts.QuadraticDistance)(**kw)
    tc = (tcosts.SaturatedDistance if saturated else tcosts.QuadraticDistance)(**kw)
    states = np.random.default_rng(6).standard_normal((9, 8, 4)) * 3.0
    u = np.zeros((9, 8, 1))
    (cj, sj), gj = jax.value_and_grad(lambda s: jc(s, jnp.asarray(u)), has_aux=True)(
        jnp.asarray(states))
    st = torch.as_tensor(states).requires_grad_(True)
    ct, s_t = tc(st, torch.as_tensor(u))
    (gt,) = torch.autograd.grad(ct, st)
    np.testing.assert_allclose(ct.item(), float(cj), **TIGHT)
    np.testing.assert_allclose(s_t.item(), float(sj), **TIGHT)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TIGHT)
    # |theta_v|: the -pi upright costs what the +pi one does
    up = torch.zeros(1, 1, 4, dtype=torch.float64)
    up[..., 1] = np.pi
    assert float(tc.stage_costs(up, None)) == float(tc.stage_costs(-up, None)) == 0.0


# ------------------------------------------------------------------ GP, rollout


def _furuta_pieces(delta_cap=3.0):
    model = dict(state_dim=4, input_dim=1, dt=0.02, vel_indices=(2, 3), pos_indices=(0, 1))
    kern = lambda K: K.Sum(members=(K.SEArd(active_dims=tuple(range(5))),
                                    K.Linear(active_dims=tuple(range(5, 12)), offset=False)))
    pol = dict(feature_dim=6, input_dim=1, num_basis=NB, u_max=3.0, angle_indices=(0, 1),
               non_angle_indices=(2, 3), scale_factor=(15.0, 30.0, 1.0, 1.0, 1.0, 1.0),
               reinit_lengthscales=(1.0,) * 6, reinit_centers=(1.0,) * 6, reinit_weight=3.0)
    cost = dict(target_state=(np.pi, 0.0), lengthscales=(2.0, 4.0), active_dims=(1, 0),
                abs_dims=(1,))
    out = {}
    for tag, dyn, K, gp, pm, cm, rm in (("j", jdyn, jK, jgp, jpol, jcosts, jroll),
                                        ("t", tdyn, tK, tgp, tpol, tcosts, troll)):
        m = dyn.FurutaSemiparametric(**model)
        g = gp.MultiGP(kernel=kern(K), num_heads=G, normalize_outputs=True)
        p = pm.SumOfGaussiansWithAngles(**pol)
        out[tag] = dict(model=m, gp=g, policy=p, cost=cm.SaturatedDistance(**cost),
                        engine=rm.RolloutEngine(model=m, gp=g, policy=p, delta_cap=delta_cap))
    return out["j"], out["t"]


@pytest.fixture(scope="module")
def furuta_problem():
    """Two 2-s random-input trials of the QUBE-like plant (port, CPU; N=200 in
    a 256 bucket), the JAX Sum(SEArd, Linear) fit of 150 epochs with output
    normalization, its posterior, and both carried into the port."""
    j, t = _furuta_pieces()
    plant = ODEPlant(ode_name="furuta_qube", noise_std=(1e-3,) * 4)
    expl = tpol.RandomExploration(state_dim=4, input_dim=1, u_max=3.0)
    xs, ys = [], []
    for i in range(2):
        tr = plant.rollout(tprng.fold(tprng.root_key(3), i), np.zeros(4), expl, {}, 2.0, 0.02,
                           device="cpu")
        x, y = t["model"].training_pairs(torch.as_tensor(tr.measured), torch.as_tensor(tr.inputs))
        xs.append(x.numpy())
        ys.append(y.numpy())
    x, y, mask = padded(np.concatenate(xs), np.concatenate(ys, axis=1), 256)
    data = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    params, losses = jax.jit(lambda p, d: j["gp"].fit(p, d, num_epochs=150, learning_rate=0.02))(
        j["gp"].init_params(), data)
    assert np.isfinite(np.asarray(losses)).all()
    post = jax.jit(j["gp"].fit_posterior)(params, data)
    tt = dict(gp=to_torch(_np(params), "cpu", into=tgp.GPParams),
              post=to_torch(_np(post), "cpu", into=tgp.Posterior))
    return j, t, (x, y, mask), params, post, tt


def test_semiparametric_gp_matches_jax(x64, furuta_problem):
    """MLL, posterior and predict of Sum(SEArd, Linear) with
    normalize_outputs, on the JAX-fitted parameters carried by to_torch,
    in float64; predict also far off the data, where the Linear member
    extrapolates."""
    j, t, (x, y, mask), params, _, _ = furuta_problem
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    tp = to_torch(_np(p64), "cpu", into=tgp.GPParams)
    data = jgp.GPData(*(jnp.asarray(a, jnp.float64) for a in (x, y, mask)))
    tdata = tgp.GPData(*(torch.as_tensor(a, dtype=torch.float64) for a in (x, y, mask)))
    norm_j, norm_t = j["gp"].output_norms(data), t["gp"].output_norms(tdata)
    np.testing.assert_allclose(norm_t.numpy(), np.asarray(norm_j), rtol=1e-12)
    np.testing.assert_allclose(float(t["gp"].mll(tp, tdata, norm_t)),
                               float(j["gp"].mll(p64, data, norm_j)), rtol=1e-9)
    jpost = j["gp"].fit_posterior(p64, data)
    tpost = t["gp"].fit_posterior(tp, tdata)
    for name in ("alpha", "var_factor", "norm"):
        want = np.asarray(getattr(jpost, name))
        np.testing.assert_allclose(getattr(tpost, name).numpy(), want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max(), err_msg=name)
    rng = np.random.default_rng(8)
    near = x[:20] + 0.05 * rng.standard_normal((20, 12))
    far = x[:10] * np.array([1, 1, 3, 3, 1] + [9.0] * 7)  # velocities x3: features grow
    xs = np.concatenate([near, far])
    mj, vj = j["gp"].predict(p64, jpost, jnp.asarray(xs))
    mt, vt = t["gp"].predict(tp, tpost, torch.as_tensor(xs))
    for got, want, name in ((mt, mj, "mean"), (vt, vj, "var")):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max(), err_msg=name)
    assert float(vt[:, 20:].mean()) > 10 * float(vt[:, :20].mean())  # off the data


def test_per_head_prior_mean_matches_jax(x64, furuta_problem):
    """A kernel whose prior mean has per-head parameters (Linear's
    ``mean_w``, different per head) through ``MultiGP``: the [G, N] mean
    enters the MLL, the posterior's alpha and the predicted mean as JAX's."""
    _, _, (x, y, mask), _, _, _ = furuta_problem
    kern = lambda K: K.Sum(members=(K.SEArd(active_dims=tuple(range(5))),
                                    K.Linear(active_dims=tuple(range(5, 12)), offset=False)))
    jg = jgp.MultiGP(kernel=kern(jK), num_heads=G, normalize_outputs=True)
    tg = tgp.MultiGP(kernel=kern(tK), num_heads=G, normalize_outputs=True)
    w = np.random.default_rng(9).standard_normal((G, 7)) * 0.3
    params = jg.init_params(per_head_overrides=[
        {"member_overrides": [{}, {"sigma_diag": 0.5, "mean_w": w[h]}]} for h in range(G)],
        dtype=jnp.float64)
    tp = to_torch(_np(params), "cpu", into=tgp.GPParams)
    data = jgp.GPData(*(jnp.asarray(a, jnp.float64) for a in (x, y, mask)))
    tdata = tgp.GPData(*(torch.as_tensor(a, dtype=torch.float64) for a in (x, y, mask)))
    mean_t = tg._mean(tp.kernel, tdata.x)
    assert mean_t.shape == (G, len(x)) and not torch.allclose(mean_t[0], mean_t[1])
    np.testing.assert_allclose(float(tg.mll(tp, tdata, tg.output_norms(tdata))),
                               float(jg.mll(params, data, jg.output_norms(data))), rtol=1e-9)
    jpost, tpost = jg.fit_posterior(params, data), tg.fit_posterior(tp, tdata)
    want = np.asarray(jpost.alpha)
    np.testing.assert_allclose(tpost.alpha.numpy(), want, rtol=1e-7, atol=1e-7 * np.abs(want).max())
    mj, _ = jg.predict(params, jpost, data.x[:30])
    mt, _ = tg.predict(tp, tpost, tdata.x[:30])
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-7,
                               atol=1e-7 * np.abs(np.asarray(mj)).max())


def _rollout_inputs(seed=1):
    """Initial particles [P, 4]; particles 0-3 start with velocities far
    outside the data, so the delta cap binds there."""
    rng = np.random.default_rng(seed)
    s0 = 0.05 * rng.standard_normal((P, 4))
    s0[:4, 2:] = [[25.0, -40.0], [-30.0, 35.0], [20.0, 45.0], [-25.0, -30.0]]
    return s0.astype(np.float32)


def test_furuta_rollout_cost_and_gradient_match_jax(furuta_problem, monkeypatch):
    """10 steps, P=16, dropout 0.25, with the JAX draws; the cap binds on the
    particles that start off the data (checked on the port's predictions)."""
    j, t, _, params, post, tt = furuta_problem
    pol = j["policy"].init_params(jax.random.PRNGKey(2))
    s0 = _rollout_inputs()
    key, p_drop = jax.random.PRNGKey(4), 0.25

    def cost_j(pp):
        res = j["engine"].simulate(key, pp, params, post, jnp.asarray(s0), T, p_dropout=p_drop)
        return j["cost"](res.states, res.inputs)[0]

    cj, gj = jax.jit(jax.value_and_grad(cost_j))(pol)
    seen = []
    predict = tgp.MultiGP.predict

    def spy(self, *a):
        mean, var = predict(self, *a)
        seen.append(mean.detach().abs() > 3.0 * tt["post"].norm[:, None])
        return mean, var

    monkeypatch.setattr(tgp.MultiGP, "predict", spy)
    noise = jax_rollout_noise(key, P, T, G, NB, p_drop)
    leaves = {k: v.clone().requires_grad_(True) for k, v in to_torch(_np(pol), "cpu").items()}
    res = t["engine"].simulate(None, leaves, tt["gp"], tt["post"], torch.as_tensor(s0), T,
                               p_dropout=p_drop, noise=noise)
    assert res.states.shape == (T, P, 4)
    ct, _ = t["cost"](res.states, res.inputs)
    gt = torch.autograd.grad(ct, list(leaves.values()))
    bound = torch.stack(seen).any(dim=(0, 1))  # [P]: capped at some step and head
    assert bound[:4].any() and not bound.all()
    assert torch.isfinite(res.states).all()
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-3)
    for name, g in zip(leaves, gt):
        scale = float(np.abs(np.asarray(gj[name])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]), rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("lanes", ["restarts", "seeds"])
def test_furuta_rollout_lanes_match_jax_vmap(furuta_problem, lanes):
    """Two lanes: restart lanes share the posterior (the cap's norm [G]
    against predictions [R, G, P]); seed lanes carry their own ([L, G]
    against [L, G, P]); each against ``jax.vmap`` of the JAX rollout."""
    j, t, _, params, post, tt = furuta_problem
    pols = [j["policy"].init_params(jax.random.PRNGKey(i)) for i in (2, 5)]
    jpol_l = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pols)
    s0 = np.stack([_rollout_inputs(1), _rollout_inputs(2)])
    keys = [jax.random.PRNGKey(4), jax.random.PRNGKey(9)]
    jkeys, p_drop = jnp.stack(keys), 0.25
    if lanes == "seeds":  # the second seed's posterior: targets scaled, so norm differs
        post2 = post._replace(norm=post.norm * 1.5)
        jpost = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), post, post2)
        jparams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), params, params)
        tpost = to_torch(_np(jpost), "cpu", into=tgp.Posterior)
        tparams = to_torch(_np(jparams), "cpu", into=tgp.GPParams)
        axes = (0, 0, 0, 0, 0)
    else:
        jpost, jparams, tpost, tparams = post, params, tt["post"], tt["gp"]
        axes = (0, 0, 0, None, None)

    def cost_j(pp, s, k, gpp, pst):
        res = j["engine"].simulate(k, pp, gpp, pst, s, T, p_dropout=p_drop)
        return j["cost"](res.states, res.inputs)[0]

    def total(pp):
        c = jax.vmap(cost_j, in_axes=axes)(pp, jnp.asarray(s0), jkeys, jparams, jpost)
        return jnp.sum(c), c

    (_, cj), gj = jax.jit(jax.value_and_grad(total, has_aux=True))(jpol_l)
    noise = troll.stack_lanes([jax_rollout_noise(k, P, T, G, NB, p_drop) for k in keys])
    leaves = {k: v.clone().requires_grad_(True) for k, v in to_torch(_np(jpol_l), "cpu").items()}
    res = t["engine"].simulate(None, leaves, tparams, tpost, torch.as_tensor(s0), T,
                               p_dropout=p_drop, noise=noise)
    assert res.states.shape == (T, 2, P, 4)
    ct, _ = t["cost"](res.states, res.inputs)
    gt = torch.autograd.grad(ct.sum(), list(leaves.values()))
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj), rtol=1e-3)
    for name, g in zip(leaves, gt):
        scale = float(np.abs(np.asarray(gj[name])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]), rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=name)


def test_delta_cap_needs_normalized_outputs():
    _, t = _furuta_pieces(delta_cap=None)
    gp = dataclasses.replace(t["gp"], normalize_outputs=False)
    with pytest.raises(ValueError, match="delta_cap"):
        troll.RolloutEngine(model=t["model"], gp=gp, policy=t["policy"], delta_cap=3.0)
    troll.RolloutEngine(model=t["model"], gp=gp, policy=t["policy"])


# ------------------------------------------------------------------ scenario


def test_furuta_smoke_config_trains_end_to_end_on_cpu(tmp_path):
    cfg = dataclasses.replace(tfur.FurutaConfig(seed=2).smoke(), opt_steps=(3,), gp_epochs=40)
    agent, kwargs = tfur.build(cfg, "cpu")
    assert agent.optimizer.horizon == 150 and agent.optimizer.engine.delta_cap == 3.0
    assert agent.gp.normalize_outputs and agent.gp._fused_structure() is None
    logs = agent.reinforce(**kwargs, verbose=False)
    assert len(logs) == 1 and logs[0].steps_done == 3
    assert np.all(np.isfinite(logs[0].cost_history))
    assert len(agent.trials) == 2 and agent.gp_x.shape == (300, 12)
    assert all(np.isfinite(tr.true).all() for tr in agent.trials)
    assert isinstance(tfur.swingup_success(agent.trials[-1].true), bool)
    se, _ = tfur.build(dataclasses.replace(cfg, semiparametric=False), "cpu")
    assert se.gp._fused_structure() == "se"  # K1/K2 at D=12 on the card
    logged, _ = tfur.build(dataclasses.replace(cfg, log_dir=str(tmp_path / "logs")), "cpu")
    assert os.path.isdir(tmp_path / "logs") and logged.scenario_name == "furuta"
