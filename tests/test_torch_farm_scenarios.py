"""The seed farm over every scenario the JAX package's farm takes, and the GP
options it reaches: the port against the JAX package and against the same
seed trained alone.

Same numpy inputs through both packages where the JAX function is compared.
Tolerances, and why:
- the lane offline estimator against ``jax.vmap(offline_velocity_estimation_
  jax)`` within 1e-5 of each column's max-abs (float32 filtfilt of two
  frameworks), against the port's host path within 1e-6 (the same float32
  filter; savgol's host path is float64);
- ``PMSODEPlant.rollout_lanes`` against ``rollout`` per seed: 1e-6;
- a farmed seed against the seed alone (4PMS, Furuta, MuJoCo): steps equal,
  costs rtol / atol 5e-3, the executed trial 5e-2, those of
  tests/test_multiseed.py (the fits sum in another order when batched);
- the lane Sum(SE, Linear) fit in float64: losses and parameters rtol 1e-9,
  posterior and predictions rtol 1e-7 with atol relative to the largest
  entry, as tests/test_torch_furuta.py holds that GP;
- SOD with JAX's order, the legacy variance operator in float64: masks
  equal, rtol 1e-9;
- ``gram_chunk`` in float32 against the unchunked predict, those of
  tests/test_gp.py (mean 2e-5, var 5e-4, gradient 1e-4), and in float64
  against JAX's chunked predict: rtol 1e-9;
- a farmed Furuta seed against ``MCPilco.reinforce`` over 3 whole trials:
  bitwise farmed alone, among 3 seeds within 1e-3 of each quantity's
  largest entry.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import Problem, SENSORS, SINUSOIDS, policy_kwargs
from mcpilco_tpu.envs import plants as jplants
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import kernels as jK
from mcpilco_tpu.models import sod as jsod
from mcpilco_tpu_torch.control import rollout as troll
from mcpilco_tpu_torch.envs import plants as tplants
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.models import sod as tsod
from mcpilco_tpu_torch.parallel.multiseed import SeedFarm
from mcpilco_tpu_torch.scenarios import cartpole as scen
from mcpilco_tpu_torch.scenarios import cartpole_pms as pms
from mcpilco_tpu_torch.scenarios import furuta
from mcpilco_tpu_torch.utils import prng
from mcpilco_tpu_torch.utils.cap_probe import CapShares, delta_cap_binding
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

PMS_DT = SENSORS["dt"]
SMOKE = dict(num_particles=32, opt_steps=(12,), gp_epochs=60)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _farm_against_alone(mod, cfg, seeds, seed, tweak=lambda agent: None):
    """``seed`` trained alone, and farmed among ``seeds`` (the farm's agent
    built from seed 0); both agents go through ``tweak`` first.  Returns
    (the farm's last trial log, the seed's lane, the agent alone)."""
    agent, kwargs = mod.build(cfg, "cpu")
    tweak(agent)
    agent.reinforce(**kwargs, verbose=False)
    cfg0 = dataclasses.replace(cfg, seed=0)
    farm_agent, kw = mod.build(cfg0, "cpu")
    tweak(farm_agent)
    farm = SeedFarm(farm_agent, seeds,
                    policy_init_fn=lambda k: mod.policy_init(cfg0, farm_agent.policy, k, "cpu"))
    res = farm.run(**kw, verbose=False)
    return res.trial_logs[-1], list(res.seeds).index(seed), agent


def _assert_seed_matches(log, i, agent):
    seq = agent.trial_logs[-1]
    assert int(log.steps_done[i]) == seq.steps_done
    np.testing.assert_allclose(log.cost_history[i, : seq.steps_done], seq.cost_history,
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(log.control_true[i], agent.trials[-1].true, rtol=5e-2, atol=5e-2)


# ------------------------------------------------------------------ 4PMS collection


@pytest.mark.parametrize("method", ["butter_cd", "savgol"])
def test_lane_estimator_matches_jax_and_host(method):
    rng = np.random.default_rng(3)
    L, N = 3, 91
    noisy = np.cumsum(0.05 * rng.standard_normal((L, N, 4)), axis=1).astype(np.float32)
    inputs = rng.standard_normal((L, N, 1)).astype(np.float32)
    kw = dict(pos_indices=(0, 2), vel_indices=(1, 3), method=method)
    got, got_in = tplants.offline_velocity_estimation_lanes(
        torch.as_tensor(noisy), torch.as_tensor(inputs), PMS_DT, **kw)
    want, want_in = jax.vmap(lambda n, u: jplants.offline_velocity_estimation_jax(
        n, u, PMS_DT, **kw))(jnp.asarray(noisy), jnp.asarray(inputs))
    assert got.shape == (L, N - 2, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    scale = np.abs(np.asarray(want)).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale.max())
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-5 * scale)
    for i in range(L):
        host, host_in = tplants.offline_velocity_estimation(noisy[i], inputs[i], PMS_DT, **kw)
        np.testing.assert_array_equal(got_in[i].numpy(), host_in)
        assert np.all(np.abs(got[i].numpy() - host) <= 1e-6 * np.abs(host).max(axis=0))


def test_pms_rollout_lanes_match_rollout_per_seed():
    plant = tplants.PMSODEPlant(ode_name="cartpole", noise_std=(3e-3,) * 4, pos_indices=(0, 2),
                                vel_indices=(1, 3), fc=SENSORS["fc"])
    keys = [prng.fold(prng.root_key(s), 4) for s in (1, 2)]
    s0 = np.array([[0.0, 0.0, 0.1, 0.0], [0.2, 0.0, -0.1, 0.0]], np.float32)
    sinus = tpol.SumOfSinusoids(**SINUSOIDS)
    feedback = tpol.SumOfGaussiansWithAngles(**policy_kwargs(10))
    p_sin = [sinus.init_params(prng.root_key(s)) for s in (3, 4)]
    p_fb = [feedback.init_params(prng.root_key(s)) for s in (5, 6)]
    for policy, per in ((sinus, p_sin), (feedback, p_fb)):
        params = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        lanes = plant.rollout_lanes(keys, s0, policy, params, 1.0, PMS_DT, device="cpu")
        assert lanes.true.shape == lanes.noisy.shape == (2, 31, 4)
        for i, k in enumerate(keys):
            one = plant.rollout(k, s0[i], policy, per[i], 1.0, PMS_DT, device="cpu")
            for name in ("measured", "inputs", "true", "noisy"):
                np.testing.assert_allclose(getattr(lanes, name)[i], getattr(one, name),
                                           rtol=1e-6, atol=1e-6, err_msg=name)
        assert not np.allclose(lanes.noisy[0], lanes.noisy[1])


@pytest.mark.parametrize("vel_est", ["butter_cd", "savgol"])
def test_pms_farmed_seed_matches_seed_alone(vel_est):
    """Seed 2 farmed among [2, 4] == seed 2 trained alone: the device
    estimator gives the farm the training data the host path gives the
    sequential run (tests/test_multiseed.py:74-108)."""
    cfg = dataclasses.replace(pms.CartpolePMSConfig(seed=2).smoke(), vel_est=vel_est, **SMOKE)
    log, i, agent = _farm_against_alone(pms, cfg, [2, 4], 2)
    _assert_seed_matches(log, i, agent)
    # the executed trial is trimmed to [1:-1], as the sequential path trims it
    assert log.control_true.shape == (2, 89, 4) and log.control_inputs.shape == (2, 89, 1)


# ------------------------------------------------------------------ Furuta


def test_furuta_farmed_seed_matches_seed_alone(monkeypatch):
    """Seed 3 farmed among [3, 5] == seed 3 alone, with the delta cap (cut
    to 0.5 of the largest training delta) binding."""
    bound = []
    predict = troll.RolloutEngine._predict

    def spy(self, gp_params, posterior, gp_in):
        mean, _ = self.gp.predict(gp_params, posterior, gp_in)
        bound.append(bool((mean.abs() > self.delta_cap * posterior.norm[..., None]).any()))
        return predict(self, gp_params, posterior, gp_in)

    monkeypatch.setattr(troll.RolloutEngine, "_predict", spy)

    def cap(agent):
        engine = dataclasses.replace(agent.optimizer.engine, delta_cap=0.5)
        agent.optimizer = dataclasses.replace(agent.optimizer, engine=engine)

    cfg = dataclasses.replace(furuta.FurutaConfig(seed=3).smoke(), num_particles=16,
                              opt_steps=(4,), gp_epochs=60, num_basis=20, T_control=1.0)
    log, i, agent = _farm_against_alone(furuta, cfg, [3, 5], 3, tweak=cap)
    _assert_seed_matches(log, i, agent)
    assert any(bound)


def test_lane_sum_se_linear_fit_matches_vmapped_jax(x64):
    """Two seeds' Sum(SE, Linear) fits with output normalization in one
    batched fit, against ``jax.vmap`` of the JAX fit; then the lane
    posteriors and predictions, and ``first_finite`` keeping each seed's
    own."""
    kern = lambda K: K.Sum(members=(K.SEArd(active_dims=tuple(range(5))),
                                    K.Linear(active_dims=tuple(range(5, 12)), offset=False)))
    jg = jgp.MultiGP(kernel=kern(jK), num_heads=2, normalize_outputs=True)
    tg = tgp.MultiGP(kernel=kern(tK), num_heads=2, normalize_outputs=True)
    rng = np.random.default_rng(21)
    L, n, cap = 2, 50, 64
    x = np.zeros((L, cap, 12))
    y = np.zeros((L, 2, cap))
    x[:, :n] = rng.standard_normal((L, n, 12))
    w = rng.standard_normal((L, 2, 7))
    y[:, :, :n] = np.sin(x[:, None, :n, 0]) + np.einsum("lgd,lnd->lgn", w, x[:, :n, 5:])
    y[1] *= 7.0  # the second seed's targets, and so its norm, are larger
    mask = np.zeros((L, cap))
    mask[:, :n] = 1.0
    params = jax.tree_util.tree_map(lambda l: jnp.stack([l] * L),
                                    jg.init_params(dtype=jnp.float64))
    jdata = jgp.GPData(*(jnp.asarray(a) for a in (x, y, mask)))
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    jp, jl = jax.jit(jax.vmap(lambda p, d: jg.fit(p, d, num_epochs=10, learning_rate=0.05)))(
        params, jdata)
    tp, tl = tg.fit(to_torch(_np(params), "cpu", into=tgp.GPParams), tdata, num_epochs=10,
                    learning_rate=0.05)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tgp._leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9, atol=1e-12)
    jpost = jax.vmap(jg.fit_posterior)(jp, jdata)
    tpost = tgp.first_finite([tg.fit_posterior(tp, tdata), tg.scaled(10.0).fit_posterior(tp, tdata)])
    assert not np.allclose(tpost.norm[0].numpy(), tpost.norm[1].numpy())
    for name in ("alpha", "var_factor", "norm"):
        want = np.asarray(getattr(jpost, name))
        np.testing.assert_allclose(getattr(tpost, name).numpy(), want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max(), err_msg=name)
    xs = rng.standard_normal((L, 9, 12))
    mj, vj = jax.vmap(jg.predict)(jp, jpost, jnp.asarray(xs))
    mt, vt = tg.predict(tp, tpost, torch.as_tensor(xs))
    for got, want in ((mt, mj), (vt, vj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7 * np.abs(want).max())


# ------------------------------------------------------------------ host plants


class _HostODE:
    """The flagship's ODE plant behind a host plant's rollout() protocol, as
    a MuJoCo plant presents itself: not an ``ODEPlant``."""

    def __init__(self, plant):
        self.plant = plant

    def rollout(self, key, s0, policy, policy_params, T, dt, device="cuda"):
        return self.plant.rollout(key, s0, policy, policy_params, T, dt, device=device)


def _flagship_farm(host):
    cfg = dataclasses.replace(scen.CartpoleConfig(seed=0).smoke(), num_particles=16,
                              opt_steps=(3,), gp_epochs=30)
    agent, kwargs = scen.build(cfg, "cpu")
    if host:
        agent.plant = _HostODE(agent.plant)
    farm = SeedFarm(agent, [1, 2],
                    policy_init_fn=lambda k: scen.policy_init(cfg, agent.policy, k, "cpu"))
    res = farm.run(**kwargs, verbose=False)
    return farm, res


def test_host_plant_farm_matches_the_device_farm():
    (f_dev, r_dev), (f_host, r_host) = _flagship_farm(False), _flagship_farm(True)
    assert not f_host._device_plant and f_dev._device_plant
    np.testing.assert_allclose(f_host.gp_x, f_dev.gp_x, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f_host.gp_y, f_dev.gp_y, rtol=1e-6, atol=1e-6)
    a, b = r_host.trial_logs[-1], r_dev.trial_logs[-1]
    np.testing.assert_allclose(a.cost_history, b.cost_history, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(a.control_true, b.control_true, rtol=5e-2, atol=5e-2)
    assert np.all(np.isfinite(a.cost_history))


def test_mujoco_farm_matches_sequential():
    """tests/test_multiseed.py:175-199 on the port: the MuJoCo plant stepped
    seed by seed between the batched device phases."""
    pytest.importorskip("mujoco")
    from mcpilco_tpu_torch.scenarios import cartpole_mujoco as mj

    cfg = dataclasses.replace(mj.CartpoleMujocoConfig(seed=3).smoke(), **SMOKE)
    log, i, agent = _farm_against_alone(mj, cfg, [2, 3], 3)
    np.testing.assert_allclose(log.control_true[i], agent.trials[-1].true, rtol=5e-2, atol=5e-2)


# ------------------------------------------------------------------ SOD order


def _sod_problem(rng, n=48, cap=64):
    """The flagship's SE+P(2) GP in both packages (float64 parameters) and
    a dense dataset, on which SOD drops some points and the visiting order
    changes which."""
    prob = Problem(num_basis=10)
    x = np.zeros((cap, 6))
    x[:n] = 0.05 * rng.standard_normal((n, 6))
    y = np.zeros((2, cap))
    y[:, :n] = np.stack([np.sin(3.0 * x[:n, 0]), np.cos(2.0 * x[:n, 1])])
    mask = np.zeros(cap)
    mask[:n] = 1.0
    params = jax.tree_util.tree_map(lambda l: l.astype(jnp.float64),
                                    prob.jgp.init_params(sigma_n=0.05))
    return prob, params, x, y, mask


def test_sod_with_jax_order_matches_jax(x64):
    rng = np.random.default_rng(4)
    prob, params, x, y, mask = _sod_problem(rng)
    key = jax.random.PRNGKey(11)
    jcfg = jsod.SODConfig(threshold_mode="relative", threshold=(0.5,), permutation=True)
    tcfg = tsod.SODConfig(threshold_mode="relative", threshold=(0.5,), permutation=True)
    sel_j = jsod.select(prob.jgp, jcfg, params, *(jnp.asarray(a) for a in (x, y, mask)), key)
    perm = np.asarray(jax.random.permutation(key, jnp.arange(1, x.shape[0])))
    order = torch.as_tensor(np.concatenate([[0], perm]))
    tparams = to_torch(_np(params), "cpu", into=tgp.GPParams)
    sel_t = tsod.select(prob.tgp, tcfg, tparams, *(torch.as_tensor(a) for a in (x, y, mask)),
                        order=order)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    # the order matters: index order keeps another subset
    sel_0 = tsod.select(prob.tgp, tcfg, tparams, *(torch.as_tensor(a) for a in (x, y, mask)),
                        order=torch.arange(x.shape[0]))
    assert not torch.equal(sel_0, sel_t)


def test_sod_key_order_is_a_seeded_permutation_per_lane(x64):
    n = 64
    k1, k2 = prng.fold(prng.root_key(1), 7), prng.fold(prng.root_key(2), 7)
    o1 = tsod.random_order(n, k1)
    assert o1[0] == 0 and sorted(o1.tolist()) == list(range(n))
    assert torch.equal(o1, tsod.random_order(n, k1))
    assert not torch.equal(o1, tsod.random_order(n, k2))
    lanes = tsod.random_order(n, [k1, k2])
    assert lanes.shape == (2, n) and torch.equal(lanes[0], o1)
    # each lane of a batched selection visits its own order
    rng = np.random.default_rng(5)
    prob, params, x, y, mask = _sod_problem(rng)
    tparams = to_torch(_np(params), "cpu", into=tgp.GPParams)
    cfg = tsod.SODConfig(threshold_mode="relative", threshold=(0.5,), permutation=True)
    data = [torch.as_tensor(a) for a in (x, y, mask)]
    stacked = tgp.tree_map(lambda t: torch.stack([t, t]), tparams)
    sel = tsod.select(prob.tgp, cfg, stacked, *(torch.stack([a, a]) for a in data), [k1, k2])
    for i, k in enumerate((k1, k2)):
        assert torch.equal(sel[i], tsod.select(prob.tgp, cfg, tparams, *data, k))
    assert not torch.equal(sel[0], sel[1])


# ------------------------------------------------------------------ legacy variance


@pytest.fixture
def legacy_var():
    jgp.use_legacy_variance_op(True)
    tgp.use_legacy_variance_op(True)
    try:
        yield
    finally:
        jgp.use_legacy_variance_op(False)
        tgp.use_legacy_variance_op(False)


@pytest.mark.parametrize("approx", ["exact", "sor"])
def test_legacy_variance_matches_jax(x64, legacy_var, approx):
    rng = np.random.default_rng(6)
    prob, params, x, y, mask = _sod_problem(rng)
    jg = dataclasses.replace(prob.jgp, approx=approx)
    tg = dataclasses.replace(prob.tgp, approx=approx)
    tparams = to_torch(_np(params), "cpu", into=tgp.GPParams)
    jdata = jgp.GPData(*(jnp.asarray(a) for a in (x, y, mask)))
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    if approx == "exact":
        jpost = jg.fit_posterior(params, jdata)
        tpost = tg.fit_posterior(tparams, tdata)
    else:
        sel = np.zeros((2, x.shape[0]))
        sel[:, :40:3] = 1.0
        jpost = jg.sor_posterior(params, jdata, jnp.asarray(sel))
        tpost = tg.sor_posterior(tparams, tdata, torch.as_tensor(sel))
    # the stored operator is K^-1 (Sigma for SOR), not its factor
    op = tpost.var_factor[0].numpy()
    np.testing.assert_allclose(op, op.T, rtol=1e-9, atol=1e-12 * np.abs(op).max())
    for name in ("alpha", "var_factor", "norm"):
        want = np.asarray(getattr(jpost, name))
        np.testing.assert_allclose(getattr(tpost, name).numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max(), err_msg=name)
    xs = rng.standard_normal((17, 6))
    mj, vj = jg.predict(params, jpost, jnp.asarray(xs))
    mt, vt = tg.predict(tparams, tpost, torch.as_tensor(xs))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-9, atol=1e-12)
    if approx == "exact":
        with pytest.raises(ValueError, match="legacy"):
            tg._predict_fused(tparams, tpost, torch.as_tensor(xs))


def test_legacy_variance_predicts_what_the_factor_form_does(x64, monkeypatch):
    """The same posterior variance either way (the operators differ only in
    rounding); the switch is read at import from MCPILCO_LEGACY_VAR."""
    rng = np.random.default_rng(7)
    prob, params, x, y, mask = _sod_problem(rng)
    tparams = to_torch(_np(params), "cpu", into=tgp.GPParams)
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    xs = torch.as_tensor(rng.standard_normal((17, 6)))
    out = {}
    for legacy in (False, True):
        monkeypatch.setattr(tgp, "_LEGACY_VAR", legacy)
        out[legacy] = prob.tgp.predict(tparams, prob.tgp.fit_posterior(tparams, tdata), xs)
    for a, b in zip(out[False], out[True]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)
    code = "from mcpilco_tpu_torch.models import gp; print(gp._LEGACY_VAR)"
    for flag, want in (("1", "True"), ("0", "False")):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=dict(os.environ, MCPILCO_LEGACY_VAR=flag), check=True)
        assert out.stdout.strip() == want


# ------------------------------------------------------------------ gram_chunk


@pytest.mark.parametrize("chunk", [None, 7, 64, 128])
def test_gram_chunk_matches_unchunked_and_jax(chunk):
    """tests/test_gp.py:183-210 on the port: n=100 live rows in M=128, chunks
    that do not divide M (7), divide it (64) and equal it (128); in float32
    against the unchunked predict, in float64 against JAX's chunked one."""
    rng = np.random.default_rng(8)
    n, M = 100, 128
    x = np.zeros((M, 3))
    x[:n] = rng.standard_normal((n, 3))
    y = np.zeros((2, M))
    y[:, :n] = np.stack([np.sin(x[:n, 0]), np.cos(x[:n, 1])])
    mask = np.zeros(M)
    mask[:n] = 1.0
    xs = rng.standard_normal((37, 3))
    jg = jgp.MultiGP(kernel=jK.se_plus_volterra(tuple(range(3)), 2), num_heads=2,
                     gram_chunk=chunk)
    tg = tgp.MultiGP(kernel=tK.se_plus_volterra(tuple(range(3)), 2), num_heads=2)
    tgc = dataclasses.replace(tg, gram_chunk=chunk)

    def port(gp, dtype):
        params = tg.init_params(sigma_n=0.2, dtype=dtype)
        post = tg.fit_posterior(params, tgp.GPData(*(torch.as_tensor(a, dtype=dtype)
                                                     for a in (x, y, mask))))
        s = torch.as_tensor(xs, dtype=dtype).requires_grad_(True)
        mean, var = gp.predict(params, post, s)
        (g,) = torch.autograd.grad(mean.sum(), s)
        return mean.detach().numpy(), var.detach().numpy(), g.numpy()

    got, want = port(tgc, torch.float32), port(tg, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)
    with jax.enable_x64():
        params = jg.init_params(sigma_n=0.2, dtype=jnp.float64)
        post = jg.fit_posterior(params, jgp.GPData(*(jnp.asarray(a) for a in (x, y, mask))))
        mj, vj = jg.predict(params, post, jnp.asarray(xs))
        gj = jax.grad(lambda s: jnp.sum(jg.predict(params, post, s)[0]))(jnp.asarray(xs))
        for a, b in zip(port(tgc, torch.float64), (mj, vj, gj)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)


# ------------------------------------------------------------------ the farm against reinforce


class _Recorder:
    """Every ``MultiGP.fit``'s loss history, every forced NaN's key, and the
    cap's binding masks, while patched in by :meth:`patch`."""

    def __init__(self, nan_keys):
        self.fits, self.nan_hits, self.cap = [], [], CapShares()
        self.nan_keys = {tuple(k) for k in nan_keys}

    def patch(self, monkeypatch):
        fit, draw = tgp.MultiGP.fit, troll.RolloutEngine.draw_noise

        def recorded_fit(gp, *a, **k):
            params, losses = fit(gp, *a, **k)
            self.fits.append(losses.detach().clone())
            return params, losses

        def nan_draws(engine, key, *a, **k):
            noise = draw(engine, key, *a, **k)
            if not isinstance(key, list) and tuple(key) in self.nan_keys:
                self.nan_hits.append(tuple(key))
                noise = noise._replace(state=torch.full_like(noise.state, float("nan")))
            return noise

        monkeypatch.setattr(tgp.MultiGP, "fit", recorded_fit)
        monkeypatch.setattr(troll.RolloutEngine, "draw_noise", nan_draws)
        return delta_cap_binding(self.cap)


def _assert_lane_equal(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if rtol == 0:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


WHOLE = dataclasses.replace(furuta.FurutaConfig(seed=3).smoke(), num_particles=8,
                            num_trials=3, opt_steps=(6,), gp_epochs=60, num_basis=20,
                            T_control=1.0)
NAN_STEP = 2  # every draw of trial 1's step 2 is forced NaN


def _capped(agent):
    """The delta cap cut to 0.5 of the largest training delta, so that it
    binds, and two NaN re-samples before a re-init."""
    engine = dataclasses.replace(agent.optimizer.engine, delta_cap=0.5)
    agent.optimizer = dataclasses.replace(agent.optimizer, engine=engine, max_nan_retries=2)


def _whole_nan_keys(seeds):
    return [prng.fold(prng.fold(prng.stream(prng.root_key(s), prng.STREAM_ROLLOUT), 1),
                      NAN_STEP, r * (1 << 20)) for s in seeds for r in range(3)]


@pytest.fixture(scope="module")
def reinforced():
    """Seed 3 through ``MCPilco.reinforce``, and its recorder."""
    seq = _Recorder(_whole_nan_keys([3]))
    with pytest.MonkeyPatch.context() as m, seq.patch(m):
        agent, kwargs = furuta.build(WHOLE, "cpu")
        _capped(agent)
        agent.reinforce(**kwargs, verbose=False)
    return agent, seq


@pytest.mark.parametrize("seeds,rtol", [([3], 0.0), ([3, 5, 7], 1e-3)], ids=["alone", "among-3"])
def test_furuta_farm_matches_reinforce_over_whole_trials(reinforced, seeds, rtol, monkeypatch):
    """Seed 3 over 3 whole trials (exploration, then fit, optimization and
    collection in each), through ``MCPilco.reinforce`` and farmed, alone
    (S=1) and among 3 seeds, with the delta cap binding (:func:`_capped`)
    and every draw of trial 1's step 2 forced NaN (two re-samples, then the
    seed gives up and re-initializes).  Farmed alone, every trial's fit
    losses, cost history, steps, re-inits, NaN re-samples and collected
    trial, and the final posterior and policy, are bitwise the sequential
    run's on the CPU.  Among 3 seeds a lane's bits depend on the batch (at
    8 particles the batched rollout rounds otherwise), and the rounding
    grows over the closed-loop trials: the same steps, re-inits and NaN
    re-samples, every number within 1e-3 of its quantity's largest entry
    (2.7e-4 when last run, in the last collected trial)."""
    agent, seq = reinforced
    lanes = _Recorder(_whole_nan_keys(seeds))
    with lanes.patch(monkeypatch):
        cfg0 = dataclasses.replace(WHOLE, seed=0)
        farm_agent, kw = furuta.build(cfg0, "cpu")
        _capped(farm_agent)
        farm = SeedFarm(farm_agent, seeds,
                        policy_init_fn=lambda k: furuta.policy_init(cfg0, farm_agent.policy, k,
                                                                     "cpu"))
        res = farm.run(**kw, verbose=False)
    i = seeds.index(3)
    assert len(seq.nan_hits) == 3 and len(lanes.nan_hits) == 3 * len(seeds)
    assert seq.cap.share() > 0 and lanes.cap.array()[:, i].any()
    assert len(seq.fits) == len(lanes.fits) == len(res.trial_logs) == 3
    for t, (log, want) in enumerate(zip(res.trial_logs, agent.trial_logs)):
        _assert_lane_equal(lanes.fits[t][i], seq.fits[t], rtol)
        assert int(log.steps_done[i]) == want.steps_done == 6
        assert int(log.reinit_count[i]) == want.reinit_count == int(t == 1)
        assert int(log.nan_resamples[i]) == 3 * int(t == 1)
        assert log.reverted_epochs[i] == 0 and log.jitter_scale[i] == 1.0
        _assert_lane_equal(log.cost_history[i, : want.steps_done], want.cost_history, rtol)
    assert farm.num_collections == len(agent.trials) == 4
    for got, want in zip(farm.trials, agent.trials):
        for f in want._fields:
            _assert_lane_equal(getattr(got, f)[i], getattr(want, f), rtol)
    for got, want in zip(farm.posterior, agent.posterior):
        _assert_lane_equal(got[i], want, rtol)
    for k, v in agent.policy_params.items():
        _assert_lane_equal(res.policy_params[k][i], v, rtol)
