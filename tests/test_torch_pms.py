"""The 4PMS cart-pole slice and the multi-init variant: the port against the
JAX package, with the same numpy inputs and the JAX draws handed to the port.

Tolerances, and why:
- filters in float64: atol 1e-10 against scipy and JAX (closed-form
  coefficients; the recursions differ only in summation order); in
  float32: rtol 1e-5 against JAX.
- offline velocity estimation against the JAX host path: positions atol
  1e-5, velocities atol 1e-4 (the central difference multiplies the float32
  filter output's rounding by 1/(2 dt) = 15).
- the PMS plant in float32, 30 steps of RK4 and the measurement chain:
  rtol 1e-4 with atol 1e-4 on states, 1e-3 on the finite-difference
  velocities (gain 1/dt = 30 on position rounding).
- rollout cost and gradient with the sensor chain and bptt_clip=0.2, and 3
  optimizer steps: rtol 1e-3, as the flagship slice (float32 BPTT through
  10 closed-loop steps of two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from _torch_parity import (PMS_DT, SENSORS, SINUSOIDS, Problem, collect_data,
                           jax_rollout_noise, padded, policy_kwargs)
from mcpilco_tpu.control import rollout as jroll
from mcpilco_tpu.control import trainer as jtrainer
from mcpilco_tpu.envs import plants as jplants
from mcpilco_tpu.models import filters as jfilt
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import policies as jpol
from mcpilco_tpu.utils import prng as jprng
from mcpilco_tpu_torch.control import rollout as troll
from mcpilco_tpu_torch.control import trainer as ttrainer
from mcpilco_tpu_torch.envs import plants as tplants
from mcpilco_tpu_torch.models import filters as tfilt
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.scenarios import cartpole as tcart
from mcpilco_tpu_torch.scenarios import cartpole_pms as tpms
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

P, T, NB = 16, 10, 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ filters


@pytest.mark.parametrize("wn", [0.1, 0.5, 0.8])
def test_butter_coefficients_match_scipy_and_jax(wn):
    for order, tf, jf in ((1, tfilt.butter1, jfilt.butter1), (2, tfilt.butter2, jfilt.butter2)):
        bs, as_ = scipy.signal.butter(order, wn)
        (bt, at), (bj, aj) = tf(wn), jf(wn)
        for got, want in ((bt, bs), (at, as_), (bt, bj), (at, aj)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tfilt.lfilter_zi(*tfilt.butter2(wn)),
                               scipy.signal.lfilter_zi(*scipy.signal.butter(2, wn)), atol=1e-10)


@pytest.mark.parametrize("order", [1, 2])
def test_lfilter_filtfilt_float64_match_scipy_and_jax(x64, order):
    b, a = tfilt.butter1(0.4) if order == 1 else tfilt.butter2(0.5)
    x = np.cumsum(np.random.default_rng(order).standard_normal((80, 3)), axis=0)
    for tf, jf, sf in ((tfilt.lfilter, jfilt.lfilter, scipy.signal.lfilter),
                       (tfilt.filtfilt, jfilt.filtfilt, scipy.signal.filtfilt)):
        got = tf(b, a, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, sf(b, a, x, axis=0), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, np.asarray(jf(b, a, jnp.asarray(x))), rtol=0, atol=1e-10)


def test_filters_float32_match_jax():
    b, a = tfilt.butter2(0.5)
    x = np.cumsum(np.random.default_rng(3).standard_normal((91, 2)), axis=0).astype(np.float32)
    for tf, jf in ((tfilt.lfilter, jfilt.lfilter), (tfilt.filtfilt, jfilt.filtfilt)):
        got = tf(b, a, torch.as_tensor(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jf(b, a, jnp.asarray(x))), rtol=1e-5,
                                   atol=1e-6)
    b1, a1 = tfilt.butter1(0.3)
    xt, xtm1, ytm1 = (np.float32(v) for v in (0.3, -0.2, 0.7))
    assert abs(tfilt.iir_step(b1, a1, xt, xtm1, ytm1)
               - float(jfilt.iir_step(b1, a1, xt, xtm1, ytm1))) < 1e-6
    with pytest.raises(ValueError, match="padlen"):
        tfilt.filtfilt(b, a, torch.zeros(9))


@pytest.mark.parametrize("method", ["butter_cd", "savgol"])
def test_offline_velocity_estimation_matches_jax_host_path(method):
    rng = np.random.default_rng(4)
    t = np.arange(91) * PMS_DT
    true = np.stack([np.sin(2 * t), 2 * np.cos(2 * t), 3 * np.sin(t), 3 * np.cos(t)], axis=1)
    noisy = (true + 3e-3 * rng.standard_normal(true.shape)).astype(np.float32)
    inputs = rng.standard_normal((91, 1)).astype(np.float32)
    args = (noisy, inputs, PMS_DT, (0, 2), (1, 3))
    st, it = tplants.offline_velocity_estimation(*args, method=method)
    sj, ij = jplants.offline_velocity_estimation(*args, method=method)
    assert st.shape == (89, 4) and st.dtype == sj.dtype
    np.testing.assert_allclose(st[:, [0, 2]], sj[:, [0, 2]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(st[:, [1, 3]], sj[:, [1, 3]], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(it, ij)
    # the estimate follows the true velocities (|v| up to 3), away from the edges
    assert np.abs(st[5:-5, [1, 3]] - true[1:-1][5:-5, [1, 3]]).mean() < 0.1
    if method == "savgol":
        A = tplants._savgol_fit_matrix(91, 7, 5, 1, PMS_DT)
        ref = scipy.signal.savgol_filter(noisy[:, 0].astype(np.float64), 7, 5, deriv=1,
                                         delta=PMS_DT, mode="interp")
        np.testing.assert_allclose(A @ noisy[:, 0].astype(np.float64), ref, atol=1e-9)
    with pytest.raises(ValueError, match="unknown offline filter method"):
        tplants.offline_velocity_estimation(*args, method="kalman")


# ------------------------------------------------------------------ policy, plant


@pytest.mark.parametrize("squash", [False, True])
def test_sum_of_sinusoids_matches_jax(x64, squash):
    kw = dict(SINUSOIDS, squash_output=squash, u_max=1.5)
    jp, tp = jpol.SumOfSinusoids(**kw), tpol.SumOfSinusoids(**kw)
    params = jp.init_params(jax.random.PRNGKey(0), dtype=jnp.float64)
    tparams = to_torch(_np(params), "cpu")
    states = np.zeros((3, 4))
    for t in (0, 1, 7, 45):
        uj = jp.apply(params, jnp.asarray(states), t)
        ut = tp.apply(tparams, torch.as_tensor(states), t)
        assert ut.shape == (3, 1)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-9, atol=1e-12)
    # the port's own draw: amplitudes in range, |omega| in range, |phase| <= pi/2
    own = tp.init_params(tprng.root_key(1))
    assert torch.all(own["amplitudes"] == 1.0)
    w = own["omega"].abs()
    assert torch.all(w >= 0.1 * 2 * np.pi - 1e-6) and torch.all(w <= 4 * np.pi + 1e-6)
    assert torch.all(own["phases"].abs() <= np.pi / 2 + 1e-6)
    assert (own["omega"] > 0).any() and (own["omega"] < 0).any()


@pytest.mark.parametrize("policy", ["sinusoids", "feedback"])
def test_pms_plant_matches_jax(policy):
    plant_kw = dict(ode_name="cartpole", noise_std=(3e-3,) * 4, pos_indices=(0, 2),
                    vel_indices=(1, 3), fc=SENSORS["fc"])
    if policy == "sinusoids":
        jp, tp = jpol.SumOfSinusoids(**SINUSOIDS), tpol.SumOfSinusoids(**SINUSOIDS)
        params = jp.init_params(jax.random.PRNGKey(2))
    else:
        jp = jpol.SumOfGaussiansWithAngles(**policy_kwargs(NB))
        tp = tpol.SumOfGaussiansWithAngles(**policy_kwargs(NB))
        params = Problem(NB).policy_params(seed=2)
    key, s0, n = jax.random.PRNGKey(7), np.array([0.1, 0.0, 0.2, 0.0]), 30
    tj = jplants.PMSODEPlant(**plant_kw).rollout(key, s0, jp, params, T=1.0, dt=PMS_DT)
    k_meas = jprng.stream(key, jprng.STREAM_MEAS_NOISE)
    eps = np.stack([np.asarray(jax.random.normal(jprng.fold(k_meas, i + 1), (4,)))
                    for i in range(n)])
    tt = tplants.PMSODEPlant(**plant_kw).rollout(tprng.root_key(7), s0, tp,
                                                  to_torch(_np(params), "cpu"), 1.0, PMS_DT,
                                                  device="cpu", eps=torch.as_tensor(eps))
    assert tt.measured.shape == tt.true.shape == tt.noisy.shape == (n + 1, 4)
    assert tt.inputs.shape == (n + 1, 1)
    np.testing.assert_array_equal(tt.measured[0], s0.astype(np.float32))
    for name in ("true", "measured", "noisy", "inputs"):
        got, want = getattr(tt, name), np.asarray(getattr(tj, name))
        np.testing.assert_allclose(got[:, [0, 2]] if got.shape[1] == 4 else got,
                                   want[:, [0, 2]] if want.shape[1] == 4 else want,
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        if got.shape[1] == 4:
            np.testing.assert_allclose(got[:, [1, 3]], want[:, [1, 3]], rtol=1e-4, atol=1e-3,
                                       err_msg=name)
    # velocities are estimated, not measured
    assert not np.allclose(tt.measured[:, 1], tt.true[:, 1])


# ------------------------------------------------------------------ rollout, optimizer


@pytest.fixture(scope="module")
def pms_problem():
    """The 4PMS pieces with a JAX-fitted SE posterior on 88 pairs of one
    sinusoid-exploration trial (bucket 128), carried into the port."""
    prob = Problem(num_basis=NB, pms=True)
    x, y, mask = padded(*collect_data(pms=True), 128)
    data = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    params, _ = jax.jit(lambda p, d: prob.jgp.fit(p, d, num_epochs=100, learning_rate=0.05))(
        prob.jgp.init_params(), data)
    post = jax.jit(prob.jgp.fit_posterior)(params, data)
    t = dict(gp=to_torch(_np(params), "cpu", into=tgp.GPParams),
             post=to_torch(_np(post), "cpu", into=tgp.Posterior))
    return prob, params, post, t


def _assert_grads_close(gt, gj, names):
    for name, g in zip(names, gt):
        scale = float(np.abs(np.asarray(gj[name])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]), rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("clip", [0.2, 2e-4])
def test_pms_rollout_cost_and_gradient_match_jax(pms_problem, clip):
    """clip=0.2 is the scenario's cap; at this size (cost averaged over 16
    particles x 10 steps) per-particle cotangents stay under it, so 2e-4
    makes the clip bind on all three carried tensors."""
    prob, params, post, t = pms_problem
    jengine = dataclasses.replace(prob.jengine, bptt_clip=clip)
    tengine = dataclasses.replace(prob.tengine, bptt_clip=clip)
    pol = prob.policy_params()
    s0 = (0.05 * np.random.default_rng(0).standard_normal((P, 4))).astype(np.float32)
    key, p_drop = jax.random.PRNGKey(3), 0.25

    def cost_j(pp):
        res = jengine.simulate(key, pp, params, post, jnp.asarray(s0), T, p_dropout=p_drop)
        return prob.jcost(res.states, res.inputs)[0]

    cj, gj = jax.jit(jax.value_and_grad(cost_j))(pol)
    noise = jax_rollout_noise(key, P, T, 2, NB, p_drop, n_pos=2)
    leaves = {k: v.clone().requires_grad_(True) for k, v in to_torch(_np(pol), "cpu").items()}
    res = tengine.simulate(None, leaves, t["gp"], t["post"], torch.as_tensor(s0), T,
                           p_dropout=p_drop, noise=noise)
    assert res.states.shape == (T, P, 4) and res.inputs.shape == (T, P, 1)
    ct, _ = prob.tcost(res.states, res.inputs)
    gt = torch.autograd.grad(ct, list(leaves.values()))
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-3)
    _assert_grads_close(gt, gj, leaves)
    # the sensor chain is in the loop: without it the trajectory differs
    plain = dataclasses.replace(tengine, sensors=None)
    with torch.no_grad():
        r0 = plain.simulate(None, leaves, t["gp"], t["post"], torch.as_tensor(s0), T,
                            p_dropout=p_drop, noise=noise)
    assert not torch.allclose(r0.states[2:], res.states[2:].detach())


def test_pms_rollout_cost_and_optimizer_steps_match_jax(pms_problem):
    prob, params, post, t = pms_problem
    pol = prob.policy_params()
    kw = dict(engine=None, cost=None, init_dist=None, num_particles=P, horizon=T,
              max_opt_steps=5, min_diff_cost=0.08, num_min_diff_cost=20, min_step=10.0,
              lr_min=0.0025, p_drop_reduction=0.125)
    jopt = jtrainer.PolicyOptimizer(**dict(kw, engine=prob.jengine, cost=prob.jcost,
                                           init_dist=prob.jinit))
    topt = ttrainer.PolicyOptimizer(**dict(kw, engine=prob.tengine, cost=prob.tcost,
                                           init_dist=prob.tinit))
    t_pol = to_torch(_np(pol), "cpu")
    p_drop = 0.25

    key = jax.random.PRNGKey(11)
    (cj, _), gj = jax.jit(jax.value_and_grad(jopt._rollout_cost, has_aux=True))(
        pol, params, post, key, jnp.float32(p_drop), 0)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t_pol.items()}
    noise = jax_rollout_noise(key, P, T, 2, NB, p_drop, init_dim=4, n_pos=2)
    lanes = {k: v[None] for k, v in leaves.items()}  # one lane
    ct, _ = topt._rollout_cost(lanes, t["gp"], t["post"], [tprng.root_key(11)], p_drop, 0,
                               troll.stack_lanes([noise]))
    ct = ct[0]
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-3)
    _assert_grads_close(torch.autograd.grad(ct, list(leaves.values())), gj, leaves)

    jkey, tkey = jax.random.PRNGKey(5), tprng.root_key(5)

    def noise_fn(k):
        return jax_rollout_noise(jprng.fold(jkey, *k[len(tkey):]), P, T, 2, NB, p_drop,
                                 init_dim=4, n_pos=2)

    jres = jopt.optimize(jkey, pol, params, post, 3, 0.01, p_drop)
    tres = topt.optimize(tkey, t_pol, t["gp"], t["post"], 3, 0.01, p_drop, noise_fn=noise_fn)
    assert tres.steps_done == int(jres.steps_done) == 3
    np.testing.assert_allclose(tres.cost_history.numpy(), np.asarray(jres.cost_history),
                               rtol=1e-3)
    for name, v in tres.policy_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jres.policy_params[name]), atol=1e-5,
                                   err_msg=name)
    assert tres.reinit_count == int(jres.reinit_count) == 0


def test_pms_rollout_clips_every_carried_tensor(pms_problem, monkeypatch):
    """The clip wraps the state, the raw measurement and the filtered
    velocity once per step (the JAX step's three _clip_bptt calls)."""
    prob, _, _, t = pms_problem
    clipped = []

    def spy(x, cap):
        clipped.append((tuple(x.shape), cap))
        return x

    monkeypatch.setattr(troll, "_clip_bptt", spy)
    noise = prob.tengine.draw_noise(tprng.root_key(1), P, T, 0.0, "cpu")
    prob.tengine.simulate(None, to_torch(_np(prob.policy_params()), "cpu"), t["gp"], t["post"],
                          torch.zeros(P, 4), T, noise=noise)
    assert clipped == [((P, 4), 0.2), ((P, 4), 0.2), ((P, 2), 0.2)] * (T - 1)


def test_draw_noise_has_the_sensor_stream():
    prob = Problem(num_basis=NB, pms=True)
    n = prob.tengine.draw_noise(tprng.root_key(0), P, T, 0.25, "cpu")
    assert n.state.shape == (T - 1, P, 2) and n.meas.shape == (T - 1, P, 2)
    assert n.keep.shape == (T, P, NB)
    assert dataclasses.replace(prob.tengine, sensors=None).draw_noise(
        tprng.root_key(0), P, T, 0.0, "cpu").meas is None


# ------------------------------------------------------------------ scenarios


def test_pms_smoke_config_trains_end_to_end_on_cpu():
    cfg = tpms.CartpolePMSConfig(seed=2).smoke()
    agent, kwargs = tpms.build(cfg, "cpu")
    assert agent.optimizer.horizon == 90 and agent.optimizer.engine.bptt_clip == 0.2
    logs = agent.reinforce(**kwargs, verbose=False)
    assert len(logs) == 1 and logs[0].steps_done > 0
    assert np.all(np.isfinite(logs[0].cost_history))
    assert len(agent.trials) == 2  # exploration + the controlled trial
    # 91 samples per trial, trimmed to [1:-1] by the offline estimation
    for trial in agent.trials:
        assert trial.measured.shape == trial.true.shape == (89, 4)
        assert np.all(np.isfinite(trial.true))
    assert agent.gp_x.shape[0] == 2 * 88
    assert agent.posterior.x_tr.shape[0] == 128  # N=88 at the fit, exact GP in a 128 bucket
    agent2, _ = tpms.build(dataclasses.replace(cfg, num_restarts=2, restart_vmap=False), "cpu")
    assert (agent2.optimizer.num_restarts, agent2.optimizer.restart_vmap) == (2, False)


def test_initial_state_distributions_match_jax():
    key, n = jax.random.PRNGKey(4), 64
    uni = dict(kind="uniform", low=[-1.0, 0.0, -2.0, 0.5], high=[1.0, 2.0, 0.0, 0.75])
    jd, td = jroll.InitialStateDistribution(**uni), troll.InitialStateDistribution(**uni)
    u = jax.random.uniform(key, (n, 4))
    np.testing.assert_allclose(
        td.sample(None, n, "cpu", eps=torch.tensor(np.asarray(u))).numpy(),
        np.asarray(jd.sample(key, n)), rtol=1e-6, atol=1e-7)

    mg = dict(kind="multi_gauss", mean=[[1.0, 0.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0]],
              var=[[1e-4] * 4, [4e-4] * 4])
    jd, td = jroll.InitialStateDistribution(**mg), troll.InitialStateDistribution(**mg)
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (n,), 0, 2)
    eps = jax.random.normal(k2, (n, 4))
    got = td.sample(None, n, "cpu", eps=torch.tensor(np.asarray(eps)),
                    idx=torch.tensor(np.asarray(idx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.sample(key, n)), rtol=1e-6, atol=1e-7)
    # the port's own draws: bimodal, inside the box
    own = td.sample(tprng.root_key(0), 2000, "cpu")
    assert 0.4 < float((own[:, 0] < 0).float().mean()) < 0.6
    assert float(own[:, 1:].abs().max()) < 0.2
    box = troll.InitialStateDistribution(**uni).sample(tprng.root_key(0), 2000, "cpu")
    assert torch.all(box >= torch.tensor(uni["low"])) and torch.all(box < torch.tensor(uni["high"]))
    with pytest.raises(ValueError, match="unknown initial distribution"):
        troll.InitialStateDistribution(kind="cauchy")


def test_multi_init_smoke_config_trains_end_to_end_on_cpu():
    agent, kwargs = tcart.build(tcart.CartpoleConfig(seed=3, multi_init=True).smoke(), "cpu")
    assert agent.init_dist.kind == "multi_gauss"
    c = agent.policy_params["centers"]
    assert float(c[:, :2].abs().max()) <= 2.0 and float(c[:, 2].abs().max()) > 2.0 * np.pi / 2
    logs = agent.reinforce(**kwargs, verbose=False)
    assert len(logs) == 1 and logs[0].steps_done > 0
    assert np.all(np.isfinite(logs[0].cost_history))
    # the real trials start near x = +-1 m
    assert all(abs(abs(tr.true[0, 0]) - 1.0) < 0.1 for tr in agent.trials)
    # the optimizer's particles come from both modes
    assert (agent.trial_logs[0].particles_states[0, :, 0] > 0).any()
    assert (agent.trial_logs[0].particles_states[0, :, 0] < 0).any()
