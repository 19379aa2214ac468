"""The Subset-of-Regressors GP of the port against the JAX package.

Same numpy data, selections and hyperparameters through both packages.
Tolerances, and why:
- posterior, MLL, predict and x*'s gradient in float64: rtol 1e-7 (the same
  formulas; only the LAPACK calls' summation order differs), and the SOR MLL
  against the exact MLL at a full inducing set rtol 1e-5 (jitter 1e-8 on
  K_UU for the whitening, as in tests/test_sor.py);
- fit_sor in float32, 40 Adam epochs: losses rtol 1e-4, parameters and
  trained inducing inputs atol 1e-4 (float32 Choleskys of two frameworks,
  carried through 40 steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import padded
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import kernels as jK
from mcpilco_tpu.models import sod as jsod
from mcpilco_tpu_torch.control import mc_pilco as tmc
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models import sod as tsod
from mcpilco_tpu_torch.scenarios import cartpole as tcart
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

N, CAP, D = 40, 64, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _problem(dtype=np.float64, jitter=1e-8):
    """Two heads over a 3-dim input, a JAX SOD selection (absolute 0.5) and
    hyperparameters moved off their init, in both packages."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-2, 2, (N // 2, D)), rng.uniform(-2, 2, (N // 4, D))])
    x = np.concatenate([x, x[: N - len(x)] + 0.01 * rng.standard_normal((N - len(x), D))])
    y = np.stack([np.sin(x[:, 0]) + 0.5 * x[:, 1], np.cos(x[:, 2]) * x[:, 0]])
    y = y + 0.02 * rng.standard_normal(y.shape)
    xp, yp, mask = (a.astype(dtype) for a in padded(x, y, CAP))
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    kw = dict(num_heads=2, approx="sor", jitter=jitter, normalize_outputs=True)
    jg = jgp.MultiGP(kernel=jK.SEArd(active_dims=tuple(range(D))), **kw)
    tg = tgp.MultiGP(kernel=tK.SEArd(active_dims=tuple(range(D))), **kw)
    params = jg.init_params(sigma_n=0.1, dtype=jdt)
    params = params._replace(kernel=dict(
        params.kernel, log_lengthscales=params.kernel["log_lengthscales"]
        + jnp.asarray([[0.1, -0.2, 0.3], [0.0, 0.2, -0.1]], jdt)))
    data = jgp.GPData(x=jnp.asarray(xp), y=jnp.asarray(yp), mask=jnp.asarray(mask))
    cfg = jsod.SODConfig(threshold_mode="absolute", threshold=(0.5, 0.5))
    sel = jsod.select(jg, cfg, params, data.x, data.y, data.mask)
    t = dict(params=to_torch(_np(params), "cpu", into=tgp.GPParams),
             data=tgp.GPData(*(torch.as_tensor(a) for a in (xp, yp, mask))),
             sel=torch.tensor(np.asarray(sel)))
    return jg, tg, params, data, sel, t


def _per_head_u(data, sel):
    """Inducing inputs [G, M, D]: the data rows, moved per head on the
    selected rows."""
    x = np.asarray(data.x)
    shift = 0.05 * np.random.default_rng(1).standard_normal((2,) + x.shape)
    return (x[None] + shift * np.asarray(sel)[..., None]).astype(x.dtype)


@pytest.mark.parametrize("inducing", ["data rows", "per head"])
def test_sor_posterior_and_predict_match_jax(x64, inducing):
    jg, tg, params, data, sel, t = _problem()
    m = int(np.asarray(sel).sum(axis=-1).min())
    assert 1 < m < N, "the selection must keep a proper subset"
    u = None if inducing == "data rows" else _per_head_u(data, sel)
    jpost = jg.sor_posterior(params, data, sel, u=None if u is None else jnp.asarray(u))
    tpost = tg.sor_posterior(t["params"], t["data"], t["sel"],
                             u=None if u is None else torch.as_tensor(u))
    assert tpost.x_tr.shape == ((CAP, D) if u is None else (2, CAP, D))
    for name in ("alpha", "var_factor", "norm", "mask"):
        want = np.asarray(getattr(jpost, name))
        np.testing.assert_allclose(getattr(tpost, name).numpy(), want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max(), err_msg=name)
    xs = np.random.default_rng(2).uniform(-2, 2, (25, D))
    mj, vj = jg.predict(params, jpost, jnp.asarray(xs))
    # predict routes SOR before the lane fold: a [G, M, D] x_tr is not lanes
    mt, vt = tg.predict(t["params"], tpost, torch.as_tensor(xs))
    assert mt.shape == vt.shape == (2, 25)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-7, atol=1e-12)
    assert float(vt.min()) > 0


def test_sor_mll_matches_jax_and_exact_mll_at_full_inducing(x64):
    jg, tg, params, data, sel, t = _problem()
    for s_j, s_t in ((sel, t["sel"]), (None, None)):
        if s_j is None:  # the full inducing set
            s_j = jnp.broadcast_to(data.mask, (2, CAP))
            s_t = t["data"].mask.expand(2, CAP)
        want = float(jg.sor_mll(params, data, s_j))
        got = float(tg.sor_mll(t["params"], t["data"], s_t))
        np.testing.assert_allclose(got, want, rtol=1e-7)
    exact = dataclasses.replace(tg, approx="exact", jitter=1e-12)
    norm = tg.output_norms(t["data"])
    np.testing.assert_allclose(got, float(exact.mll(t["params"], t["data"], norm)), rtol=1e-5)


@pytest.mark.parametrize("train_inducing", [False, True])
def test_fit_sor_matches_jax(train_inducing):
    jg, tg, params, data, sel, t = _problem(np.float32, jitter=1e-4)
    jp, ju, jl = jax.jit(lambda p: jg.fit_sor(p, data, sel, 40, 0.02,
                                              train_inducing=train_inducing))(params)
    tp, tu, tl = tg.fit_sor(t["params"], t["data"], t["sel"], 40, 0.02,
                            train_inducing=train_inducing)
    assert tl.shape == (40,) and tu.shape == (2, CAP, D)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    assert float(tl[-1]) < float(tl[0]) - 1.0
    for got, want in zip(tgp._leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    moved = np.abs(tu.numpy() - np.asarray(t["data"].x)[None]).max(axis=-1)
    sel_np = t["sel"].numpy() > 0.5
    if train_inducing:
        assert moved[sel_np].max() > 1e-4 and moved[~sel_np].max() == 0.0
    else:
        assert moved.max() == 0.0


def test_fit_sor_keeps_the_last_iterate_on_a_non_finite_loss():
    """A non-finite loss keeps params, optimizer state and the logged loss
    (mcpilco_tpu/models/gp.py:601-611), then the fit goes on."""
    _, tg, _, _, _, t = _problem(np.float32, jitter=1e-4)
    calls = []
    sor_mll = tg.sor_mll

    def flaky(*a, **kw):
        calls.append(1)
        loss = sor_mll(*a, **kw)
        return loss * float("nan") if len(calls) in (3, 4) else loss

    object.__setattr__(tg, "sor_mll", flaky)
    p, _, losses = tg.fit_sor(t["params"], t["data"], t["sel"], 6, 0.02)
    object.__delattr__(tg, "sor_mll")
    p2, _, ref = tg.fit_sor(t["params"], t["data"], t["sel"], 4, 0.02)
    np.testing.assert_array_equal(losses[2:4].numpy(), losses[1].repeat(2).numpy())
    # two frozen epochs: epochs 5-6 of the flaky fit are epochs 3-4 of a clean one
    np.testing.assert_allclose(losses[4:].numpy(), ref[2:].numpy(), rtol=1e-6)
    for a, b in zip(tgp._leaves(p), tgp._leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_sor_predict_xstar_gradient_matches_jax(x64):
    jg, tg, params, data, sel, t = _problem()
    u = _per_head_u(data, sel)
    jpost = jg.sor_posterior(params, data, sel, u=jnp.asarray(u))
    tpost = tg.sor_posterior(t["params"], t["data"], t["sel"], u=torch.as_tensor(u))
    xs = np.random.default_rng(3).uniform(-2, 2, (7, D))
    w = np.linspace(0.5, 1.5, 14).reshape(2, 7)

    def f(x):
        mean, var = jg.predict(params, jpost, x)
        return jnp.sum(w * mean) + jnp.sum(var)

    gj = np.asarray(jax.grad(f)(jnp.asarray(xs)))
    x_t = torch.as_tensor(xs).requires_grad_(True)
    mean, var = tg.predict(t["params"], tpost, x_t)
    (gt,) = torch.autograd.grad(torch.sum(torch.as_tensor(w) * mean) + var.sum(), x_t)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-7, atol=1e-10)


def test_mcpilco_sor_route_records_the_refinement():
    """MCPilco with SORConfig(refine_epochs > 0, train_inducing=True):
    select -> fit_sor -> sor_posterior on per-head inducing inputs, with
    sor_points / sor_mll_first / sor_mll_last in the fit info, and the
    rollout's predict on that posterior."""
    cfg = dataclasses.replace(tcart.CartpoleConfig(seed=5).smoke(), num_particles=16,
                              opt_steps=(3,), gp_epochs=40)
    agent, _ = tcart.build(cfg, "cpu")
    agent.sod = None
    agent.sor = tsod.SORConfig(threshold_mode="relative", threshold=(0.5,), refine_epochs=30,
                               train_inducing=True)
    agent.gp = dataclasses.replace(agent.gp, approx="sor")
    agent.optimizer = dataclasses.replace(
        agent.optimizer, engine=dataclasses.replace(agent.optimizer.engine, gp=agent.gp))
    agent.collect(1.0, trial_index=0, exploration=True)
    info = agent.fit_model(tmc.ModelFitOptions(num_epochs=cfg.gp_epochs))
    assert {"sor_points", "sor_mll_first", "sor_mll_last"} <= set(info)
    assert info["sor_mll_last"] <= info["sor_mll_first"]
    assert 1 <= min(info["sor_points"]) and max(info["sor_points"]) <= 20
    assert agent.posterior.x_tr.shape == (2, 64, 6)  # trained, per head
    assert np.all(np.isfinite(agent.one_step_mse()))
    log = agent.improve_policy(tmc.PolicyOptOptions(opt_steps=3), trial_index=0)
    assert log.steps_done == 3 and np.all(np.isfinite(log.cost_history))
    with pytest.raises(ValueError, match="approx='sor'"):
        tmc.MCPilco(dt=0.05, model=agent.model, gp=dataclasses.replace(agent.gp, approx="exact"),
                    policy=agent.policy, exploration_policy=agent.exploration_policy,
                    cost=agent.cost, optimizer=agent.optimizer, device="cpu", sor=agent.sor)


def test_posterior_log_likelihood_matches_jax(x64):
    rng = np.random.default_rng(4)
    y, y_hat = rng.standard_normal((2, 9)), rng.standard_normal((2, 9))
    var = rng.uniform(0.1, 2.0, (2, 9))
    want = float(jgp.posterior_log_likelihood(*(jnp.asarray(a) for a in (y, y_hat, var))))
    got = float(tgp.posterior_log_likelihood(*(torch.as_tensor(a) for a in (y, y_hat, var))))
    np.testing.assert_allclose(got, want, rtol=1e-12)
