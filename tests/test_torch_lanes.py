"""The port's lane axis against ``jax.vmap`` of the JAX package's functions.

Where the JAX package ``vmap``s over seeds (the seed farm) or restart lanes,
the port writes a leading lane axis into its tensors.  Each test feeds the
same numpy inputs, made from a seeded generator, to ``jax.vmap`` of the JAX
function and to the port's lane-batched counterpart.  Tolerances, and why:

- K1/K2 and their plain versions, L=3, both modes: those of
  tests/test_fused_predict.py (forward rtol 2e-5 / atol 1e-5, float32 sums
  in another order; x* gradient rtol 1e-4 / atol 1e-4).  Lane l of a
  lane-batched call against the call on lane l alone: rtol 1e-6 (the same
  formulas, batched).
- GP golden math (MLL, posterior, predict, SOD) in float64: rtol 1e-9, as
  tests/test_torch_gp.py.  The 10-epoch fit in float32: rtol 1e-4 on the
  loss history (Adam compounds float32 rounding).
- The jitter escalation in float32: which variant each seed takes must
  agree exactly; the posteriors to rtol 1e-4 (the escalated seed's factor
  holds a 2x2 block with a pivot of a few float32 ulps).
- The R-lane rollout cost and policy gradient in float32 with the JAX draws
  injected: rtol 1e-3, as the single-lane rollout test (BPTT through 10
  closed-loop steps compounds two frameworks' float32 rounding).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import Problem, collect_data, jax_rollout_noise, padded
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import kernels as jK
from mcpilco_tpu.models import sod as jsod
from mcpilco_tpu.ops import fused_predict as jfp
from mcpilco_tpu_torch.control import rollout as troll
from mcpilco_tpu_torch.envs import plants as tplants
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models import sod as tsod
from mcpilco_tpu_torch.ops import fused_predict as tfp
from mcpilco_tpu_torch.scenarios import cartpole as tcart
from mcpilco_tpu_torch.scenarios import cartpole_pms as tpms
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
GOLD = dict(rtol=1e-9, atol=1e-12)
L, D = 3, 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ K1 / K2


def _kernel_inputs(P, M, seed, G=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal((L,) + s).astype(np.float32)
    return [
        np.exp(0.3 * f(G, D)), np.exp(0.2 * f(G)), 0.1 * np.exp(0.3 * f(G, D + 1)),
        0.1 * np.exp(0.3 * f(G, D)), 0.1 * np.exp(0.3 * f(G, D)), f(P, D), f(M, D), f(G, M),
        0.05 * f(G, M, M), (rng.uniform(size=(L, G, M)) > 0.2).astype(np.float32),
    ]


@pytest.mark.parametrize("use_poly", [False, True])
def test_lane_gram_contract_matches_vmapped_pallas(use_poly):
    """L=3 lanes, each with its own posterior, through the plain K1/K2 and
    GramContract, against jax.vmap of the Pallas kernels (interpret mode)."""
    P, M = 37, 40
    args = _kernel_inputs(P, M, seed=7 + use_poly)
    rng = np.random.default_rng(3)
    wk = rng.standard_normal((L, 2, P)).astype(np.float32)
    wq = rng.standard_normal((L, 2, P)).astype(np.float32)
    fwd = jax.vmap(lambda *a: jfp.fused_gram_contract(*a, use_poly=use_poly, interpret=True))
    bwd = jax.vmap(lambda *a: jfp.fused_gram_contract_bwd_xstar(*a, use_poly=use_poly,
                                                                interpret=True))
    ka_j, qd_j = fwd(*map(jnp.asarray, args))
    dx_j = np.asarray(bwd(*map(jnp.asarray, args), jnp.asarray(wk), jnp.asarray(wq)))

    t = [torch.as_tensor(a) for a in args]
    ka, qd, kf = tfp.reference_gram_contract(*t, use_poly, return_kf=True)
    assert ka.shape == qd.shape == (L, 2, P) and kf.shape == (L, 2, P, M)
    dx = tfp.reference_gram_contract_bwd_xstar(*t, kf, torch.as_tensor(wk), torch.as_tensor(wq),
                                               use_poly)
    xs = t[5].clone().requires_grad_(True)
    ka_g, qd_g = tfp.gram_contract(*t[:5], xs, *t[6:], use_poly)
    loss = torch.sum(torch.as_tensor(wk) * ka_g) + torch.sum(torch.as_tensor(wq) * qd_g)
    (dx_g,) = torch.autograd.grad(loss, xs)
    for got in ((ka, qd), (ka_g, qd_g)):
        np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ka_j), **FWD)
        np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(qd_j), **FWD)
    np.testing.assert_allclose(dx.numpy(), dx_j, **GRAD)
    np.testing.assert_allclose(dx_g.numpy(), dx_j, **GRAD)
    # each lane is the call on that lane alone
    for i in range(L):
        one = [a[i] for a in t]
        ka1, qd1, kf1 = tfp.reference_gram_contract(*one, use_poly, return_kf=True)
        dx1 = tfp.reference_gram_contract_bwd_xstar(*one, kf1, torch.as_tensor(wk[i]),
                                                    torch.as_tensor(wq[i]), use_poly)
        for got, want in ((ka[i], ka1), (qd[i], qd1), (dx[i], dx1)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_lane_kernel_wrappers_refuse_cpu_tensors_and_count_lane_blocks(monkeypatch):
    t = [torch.as_tensor(a) for a in _kernel_inputs(8, 16, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_gram_contract(*t, True)
    g = torch.ones(L, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_gram_contract_bwd_xstar(*t, torch.ones(L, 2, 8, 16), g, g, True)
    monkeypatch.setattr(tfp, "_tiles", (16, 64, 32, 32))
    monkeypatch.setattr(tfp, "_lib", object())
    assert tfp.launch_blocks(2, 400, 384, L=4) == (4 * 2 * 25 * 6, 4 * 2 * 13 * 12)
    assert tfp.launch_blocks(2, 400, 384) == (300, 312)


# ------------------------------------------------------------------ GP


def _kernels(kind):
    dims = tuple(range(D))
    if kind == "se":
        return jK.SEArd(active_dims=dims), tK.SEArd(active_dims=dims)
    return jK.se_plus_volterra(dims, degree=2), tK.se_plus_volterra(dims, degree=2)


def _both_gps(kind, **kw):
    jk, tk = _kernels(kind)
    return jgp.MultiGP(kernel=jk, num_heads=2, **kw), tgp.MultiGP(kernel=tk, num_heads=2, **kw)


def _lane_params(jg, rng, scale=0.3, dtype=jnp.float64):
    """JAX GPParams of L seeds, every leaf moved off its init value."""
    params = jg.init_params(sigma_n=0.2, dtype=dtype)
    return jax.tree_util.tree_map(
        lambda l: jnp.stack([l + scale * rng.standard_normal(l.shape).astype(l.dtype)
                             for _ in range(L)]), params)


def _lane_data(rng, n=(50, 44, 50), cap=64, dtype=np.float64, spread=1.0):
    x = np.zeros((L, cap, D), dtype)
    y = np.zeros((L, 2, cap), dtype)
    mask = np.zeros((L, cap), dtype)
    for i, ni in enumerate(n):
        x[i, :ni] = spread * rng.standard_normal((ni, D))
        y[i, :, :ni] = np.stack([np.sin(x[i, :ni, 0]) + 0.1 * x[i, :ni, 1],
                                 np.cos(x[i, :ni, 2]) * x[i, :ni, 5]])
        mask[i, :ni] = 1.0
    return x, y, mask


@pytest.mark.parametrize("kind", ["se", "se+p2"])
def test_lane_mll_posterior_predict_match_vmapped_jax(x64, kind):
    rng = np.random.default_rng(11)
    jg, tg = _both_gps(kind)
    params = _lane_params(jg, rng)
    x, y, mask = _lane_data(rng)
    jdata = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    tparams = to_torch(_np(params), "cpu", into=tgp.GPParams)

    mll_j = jax.vmap(jg.mll)(params, jdata)
    mll_t = tg.mll(tparams, tdata)
    assert mll_t.shape == (L,)
    np.testing.assert_allclose(mll_t.numpy(), np.asarray(mll_j), **GOLD)

    jpost = jax.vmap(jg.fit_posterior)(params, jdata)
    tpost = tg.fit_posterior(tparams, tdata)
    for name in ("alpha", "var_factor", "norm", "mask"):
        np.testing.assert_allclose(getattr(tpost, name).numpy(), np.asarray(getattr(jpost, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)

    xs = rng.standard_normal((L, 21, D))
    m_j, v_j = jax.vmap(jg.predict)(params, jpost, jnp.asarray(xs))
    for fn in (tg.predict, tg._predict_plain, tg._predict_fused):
        m_t, v_t = fn(tparams, tpost, torch.as_tensor(xs))
        assert m_t.shape == (L, 2, 21)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **GOLD)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **GOLD)


def test_restart_lanes_fold_into_one_predict(x64):
    """Lanes that share one posterior (restart lanes) predict as R * P
    particles of one call: the same as each lane's own call."""
    rng = np.random.default_rng(12)
    jg, tg = _both_gps("se+p2")
    params = to_torch(_np(jg.init_params(sigma_n=0.2, dtype=jnp.float64)), "cpu",
                      into=tgp.GPParams)
    x, y, mask = (a[0] for a in _lane_data(rng))
    post = tg.fit_posterior(params, tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask))))
    xs = torch.as_tensor(rng.standard_normal((L, 9, D)))
    mean, var = tg.predict(params, post, xs)
    assert mean.shape == var.shape == (L, 2, 9)
    for i in range(L):
        m1, v1 = tg.predict(params, post, xs[i])
        np.testing.assert_allclose(mean[i].numpy(), m1.numpy(), **GOLD)
        np.testing.assert_allclose(var[i].numpy(), v1.numpy(), **GOLD)


def test_lane_fit_matches_vmapped_jax_for_10_epochs():
    rng = np.random.default_rng(13)
    jg, tg = _both_gps("se+p2")
    x, y, mask = _lane_data(rng, dtype=np.float32)
    params = jax.tree_util.tree_map(lambda l: jnp.stack([l] * L), jg.init_params(sigma_n=1.0))
    jdata = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    jp, jl = jax.jit(jax.vmap(lambda p, d: jg.fit(p, d, num_epochs=10, learning_rate=0.05)))(
        params, jdata)
    tp, tl = tg.fit(to_torch(_np(params), "cpu", into=tgp.GPParams), tdata, num_epochs=10,
                    learning_rate=0.05)
    assert tl.shape == (L, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), tp, is_leaf=torch.is_tensor))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


def test_lane_fit_guard_acts_per_seed():
    """A non-finite epoch of one seed reverts that seed alone: the others
    follow the clean fit exactly."""

    @dataclasses.dataclass(frozen=True)
    class FlakyGP(tgp.MultiGP):
        calls: list = dataclasses.field(default_factory=list)

        def mll(self, params, data, norm=None):
            self.calls.append(None)
            loss = super().mll(params, data, norm)
            if len(self.calls) == 4:  # epoch 4, seed 1
                loss = loss * torch.tensor([1.0, float("nan"), 1.0])
            return loss

    rng = np.random.default_rng(14)
    x, y, mask = _lane_data(rng, dtype=np.float32)
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    gp = FlakyGP(kernel=tK.SEArd(active_dims=tuple(range(D))), num_heads=2)
    p0 = tgp.tree_map(lambda t: torch.stack([t] * L), gp.init_params(sigma_n=1.0))
    _, hist = gp.fit(p0, tdata, num_epochs=8, learning_rate=0.05)
    _, ref = tgp.MultiGP(kernel=gp.kernel, num_heads=2).fit(p0, tdata, num_epochs=8,
                                                            learning_rate=0.05)
    h, r = hist.numpy(), ref.numpy()
    np.testing.assert_array_equal(h[[0, 2]], r[[0, 2]])
    assert h[1, 3] == h[1, 2] and not np.array_equal(h[1], r[1])
    assert np.all(np.isfinite(h))


def test_lane_posterior_takes_the_first_finite_jitter_per_seed():
    """Seed 1's data holds one duplicated input; at 1x jitter (5e-8 on a
    unit diagonal, below float32's half ulp) its Gram's Cholesky meets a
    zero pivot and fails, at 10x it succeeds.  Seeds 0 and 2 keep 1x.  The
    port's choice and posteriors against jax.vmap of the three JAX variants
    with the JAX farm's per-seed selection (multiseed.py:340-348)."""
    n, cap = 40, 64
    x = np.zeros((L, cap, D), np.float32)
    x[:, :n, 0] = np.arange(n, dtype=np.float32)  # 1 apart: exp(-403) underflows
    x[1, 1] = x[1, 0]
    y = np.zeros((L, 2, cap), np.float32)
    y[:, :, :n] = np.sin(np.arange(n, dtype=np.float32))
    y[1, :, 1] = y[1, :, 0]
    mask = np.zeros((L, cap), np.float32)
    mask[:, :n] = 1.0
    kw = dict(jitter=5e-8)
    jg, tg = _both_gps("se", **kw)
    params = jg.init_params(sigma_n=1.0)
    params = params._replace(kernel=dict(params.kernel, log_lengthscales=jnp.full((2, D), -3.0)),
                             log_sigma_n=jnp.full((2,), -40.0))
    params = jax.tree_util.tree_map(lambda l: jnp.stack([l] * L), params)
    jdata = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    scales = (1.0, 10.0, 100.0)
    jposts = [jax.vmap(dataclasses.replace(jg, jitter=jg.jitter * s).fit_posterior)(params, jdata)
              for s in scales]
    finite = lambda post: jnp.stack([jnp.all(jnp.isfinite(l).reshape(L, -1), axis=1)
                                     for l in jax.tree_util.tree_leaves(post)]).all(0)
    ok0, ok1 = finite(jposts[0]), finite(jposts[1])
    assert np.asarray(ok0).tolist() == [True, False, True] and bool(ok1[1])
    pick = lambda a, b, c: jnp.where(ok0.reshape((-1,) + (1,) * (a.ndim - 1)), a,
                                     jnp.where(ok1.reshape((-1,) + (1,) * (a.ndim - 1)), b, c))
    jpost = jax.tree_util.tree_map(pick, *jposts)

    tparams = to_torch(_np(params), "cpu", into=tgp.GPParams)
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    tposts = [tg.scaled(s).fit_posterior(tparams, tdata) for s in scales]
    assert [bool(torch.isfinite(tposts[0].var_factor[i]).all()) for i in range(L)] == [
        True, False, True]
    tpost = tgp.first_finite(tposts)
    for i, want in enumerate((0, 1, 0)):
        for got, chosen in zip(tpost, tposts[want]):
            assert torch.equal(got[i], chosen[i])
    for name in ("alpha", "var_factor", "norm", "mask"):
        np.testing.assert_allclose(getattr(tpost, name).numpy(), np.asarray(getattr(jpost, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_lane_sod_select_matches_vmapped_jax(x64):
    rng = np.random.default_rng(15)
    jg, tg = _both_gps("se+p2")
    params = _lane_params(jg, rng, scale=0.1)
    x, y, mask = _lane_data(rng, n=(56, 48, 56), spread=0.2)
    cfg_j = jsod.SODConfig(threshold_mode="relative", threshold=(0.5,))
    cfg_t = tsod.SODConfig(threshold_mode="relative", threshold=(0.5,))
    sel_j = jax.vmap(lambda p, a, b, c: jsod.select(jg, cfg_j, p, a, b, c))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    sel_t = tsod.select(tg, cfg_t, to_torch(_np(params), "cpu", into=tgp.GPParams),
                        *(torch.as_tensor(a) for a in (x, y, mask)))
    assert sel_t.shape == (L, 2, 64)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert len({int(s.sum()) for s in sel_t}) > 1  # the seeds select different subsets


# ------------------------------------------------------------------ rollout


P, T, NB = 12, 10, 20


@pytest.fixture(scope="module")
def fitted():
    """The flagship problem with a JAX-fitted posterior per seed (3 seeds,
    each with its own data)."""
    prob = Problem(num_basis=NB)
    data = [padded(*collect_data(seed=s), 64) for s in range(L)]
    x, y, mask = (np.stack(a) for a in zip(*data))
    jdata = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    params = jax.tree_util.tree_map(lambda l: jnp.stack([l] * L), prob.jgp.init_params())
    params, _ = jax.jit(jax.vmap(lambda p, d: prob.jgp.fit(p, d, num_epochs=60,
                                                           learning_rate=0.05)))(params, jdata)
    post = jax.jit(jax.vmap(prob.jgp.fit_posterior))(params, jdata)
    pols = [prob.policy_params(seed=s) for s in range(1, L + 1)]
    pol = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pols)
    return prob, params, post, pol


@pytest.mark.parametrize("lanes", ["restarts", "seeds"])
def test_lane_rollout_cost_and_gradient_match_vmapped_jax(fitted, lanes):
    """R=3 restart lanes against one posterior, or 3 seeds each against its
    own, with dropout and the JAX draws injected per lane."""
    prob, params, post, pol = fitted
    if lanes == "restarts":
        params, post = (jax.tree_util.tree_map(lambda l: l[0], t) for t in (params, post))
    keys = [jax.random.PRNGKey(20 + i) for i in range(L)]
    s0 = 0.1 * np.random.default_rng(0).standard_normal((L, P, 4)).astype(np.float32)
    p_drop = 0.25

    def cost_j(pp, key, s, gpp, pst):
        res = prob.jengine.simulate(key, pp, gpp, pst, s, T, p_dropout=p_drop)
        return prob.jcost(res.states, res.inputs)[0]

    axes = (0, 0, 0, None, None) if lanes == "restarts" else (0, 0, 0, 0, 0)
    cj, gj = jax.jit(jax.vmap(jax.value_and_grad(cost_j), in_axes=axes))(
        pol, jnp.stack(keys), jnp.asarray(s0), params, post)
    noise = troll.stack_lanes([jax_rollout_noise(k, P, T, 2, NB, p_drop) for k in keys])
    t_gp = to_torch(_np(params), "cpu", into=tgp.GPParams)
    t_post = to_torch(_np(post), "cpu", into=tgp.Posterior)
    leaves = {k: v.clone().requires_grad_(True) for k, v in to_torch(_np(pol), "cpu").items()}
    res = prob.tengine.simulate(None, leaves, t_gp, t_post, torch.as_tensor(s0), T,
                                p_dropout=[p_drop] * L, noise=noise)
    assert res.states.shape == (T, L, P, 4)
    ct, _ = prob.tcost(res.states, res.inputs)
    gt = torch.autograd.grad(ct.sum(), list(leaves.values()))
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj), rtol=1e-3)
    for name, g in zip(leaves, gt):
        want = np.asarray(gj[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()), err_msg=name)


def test_lanes_with_different_dropout_rates_equal_their_own_rollouts(fitted):
    """Lanes at rates 0.25, 0 and 0.125 in one rollout: each lane equals the
    rollout of that lane alone, with the same draws.  rtol 1e-3 / atol 1e-4:
    the batched products sum in another order than a lane's own, and 10
    closed-loop steps amplify those last-bit differences to ~1e-4."""
    prob, params, post, pol = fitted
    t_gp = to_torch(_np(jax.tree_util.tree_map(lambda l: l[0], params)), "cpu", into=tgp.GPParams)
    t_post = to_torch(_np(jax.tree_util.tree_map(lambda l: l[0], post)), "cpu",
                      into=tgp.Posterior)
    t_pol = to_torch(_np(pol), "cpu")
    rates = [0.25, 0.0, 0.125]
    keys = [tprng.root_key(30 + i) for i in range(L)]
    s0 = 0.1 * torch.randn(L, P, 4, generator=torch.Generator().manual_seed(0))
    res = prob.tengine.simulate(keys, t_pol, t_gp, t_post, s0, T, p_dropout=rates)
    for i in range(L):
        one = prob.tengine.simulate(keys[i], {k: v[i] for k, v in t_pol.items()}, t_gp, t_post,
                                    s0[i], T, p_dropout=rates[i])
        np.testing.assert_allclose(res.states[:, i].numpy(), one.states.numpy(), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(res.inputs[:, i].numpy(), one.inputs.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_policy_lanes_apply_and_reinit_per_lane():
    prob = Problem(num_basis=NB)
    pol = to_torch(_np(jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *(prob.policy_params(seed=s) for s in range(L)))), "cpu")
    states = torch.randn(L, P, 4, generator=torch.Generator().manual_seed(1))
    u = prob.tpolicy.apply(pol, states, 3)
    assert u.shape == (L, P, 1)
    for i in range(L):
        one = prob.tpolicy.apply({k: v[i] for k, v in pol.items()}, states[i], 3)
        np.testing.assert_allclose(u[i].numpy(), one.numpy(), rtol=1e-6, atol=1e-7)
    keys = [tprng.root_key(40 + i) for i in range(L)]
    fresh = prob.tpolicy.reinit(pol, keys)
    for i in range(L):
        one = prob.tpolicy.reinit({k: v[i] for k, v in pol.items()}, keys[i])
        for k in pol:
            assert torch.equal(fresh[k][i], one[k])


# ------------------------------------------------------------------ entry points


def test_entry_points_default_to_the_card():
    for fn in (tcart.build, tpms.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (tplants.ODEPlant.rollout, tplants.ODEPlant.rollout_lanes,
               tplants.PMSODEPlant.rollout):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
