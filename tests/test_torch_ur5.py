"""UR5 joint-space tracking: the port against the JAX package.

Same numpy inputs and converted parameters through both packages, JAX's
draws handed to the port.  Tolerances, and why:
- the generated trajectory: bitwise (the same numpy code);
- the tracking policy, the PD law and the tracking cost in float64: rtol
  1e-12 (the same formulas in another order);
- a UR5 rollout (6 heads over a 24-dim input, the delta cap, the BPTT clip
  at 1) of 8 steps in float64, its cost and the policy gradient, with remat
  on and off in the port against JAX's ``remat=True``: rtol 1e-9, atol
  1e-9 x the leaf's largest entry;
- remat on against remat off in the port: bitwise, float32;
- checkpoints across packages: restored arrays bitwise.

The fit and the optimizer steps run on the recorded asset
(``envs/assets/ur5_pd_trials.npz``, two PD-exploration trials, N = 400),
which needs no ``mujoco``; the tests that roll out the arm import it or
skip.
"""

import dataclasses
import importlib
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_config, jax_rollout_noise
from mcpilco_tpu.control.mc_pilco import ModelFitOptions as JFit
from mcpilco_tpu.control.mc_pilco import TrialLog as JTrialLog
from mcpilco_tpu.envs import trajectories as jtraj
from mcpilco_tpu.models import costs as jcosts
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import policies as jpol
from mcpilco_tpu.scenarios import ur5 as jur5
from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions, PolicyOptOptions
from mcpilco_tpu_torch.envs import trajectories as ttraj
from mcpilco_tpu_torch.models import costs as tcosts
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.models.gp import MultiGP
from mcpilco_tpu_torch.ops import fused_predict as fp
from mcpilco_tpu_torch.scenarios import ur5 as tur5
from mcpilco_tpu_torch.utils import checkpoint as tckpt
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-12, atol=1e-13)
P, T, NB = 8, 8, 12
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(mod, **kw):
    """UR5's smoke config cut further, in either package (``mod``)."""
    kw = dict(dict(num_basis=NB, num_particles=P), **kw)
    return dataclasses.replace(mod.UR5Config(seed=1).smoke(), **kw)


# ------------------------------------------------------------ trajectory


@pytest.mark.parametrize("num_steps,kw", [(200, {}), (50, {}), (37, dict(amplitude=0.3, seed=4)),
                                          (1, {})])
def test_trajectory_matches_jax(num_steps, kw):
    want = jtraj.ur5_joint_trajectory(num_steps=num_steps, dt=0.02, **kw)
    got = ttraj.ur5_joint_trajectory(num_steps=num_steps, dt=0.02, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (num_steps, 12)


def test_reference_trajectory_names_the_missing_csv(tmp_path, monkeypatch):
    monkeypatch.delenv("MCPILCO_REFERENCE", raising=False)
    with pytest.raises(FileNotFoundError, match="MCPILCO_REFERENCE.*target_q_trajectory.csv"):
        ttraj.ur5_reference_trajectory()
    monkeypatch.setenv("MCPILCO_REFERENCE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="target_q_trajectory.csv"):
        ttraj.ur5_reference_trajectory()
    with pytest.raises(FileNotFoundError, match="target_q_trajectory.csv"):
        tur5.build(dataclasses.replace(tur5.UR5Config().smoke(), trajectory="reference"), "cpu")
    with pytest.raises(FileNotFoundError, match="UR5.xml"):
        tur5.build(dataclasses.replace(tur5.UR5Config().smoke(), plant="reference"), "cpu")
    # a recorded CSV in place is read and cut to the horizon, as in JAX
    traj = np.random.default_rng(0).standard_normal((60, 12))
    os.makedirs(tmp_path / "envs")
    np.savetxt(tmp_path / "envs" / "target_q_trajectory.csv", traj, delimiter=",")
    np.testing.assert_array_equal(ttraj.ur5_reference_trajectory(50),
                                  jtraj.ur5_reference_trajectory(50))


# --------------------------------------------------- policies and the cost


def _traj(n=10):
    return jtraj.ur5_joint_trajectory(num_steps=n, dt=0.02)


@pytest.mark.parametrize("t", [0, 4, 9, 10, 11])
@pytest.mark.parametrize("p_drop", [0.0, 0.25])
def test_tracking_policy_matches_jax(x64, t, p_drop):
    """t = 10 and 11 lie past the 10-step target: both clamp to its last row."""
    kw = dict(feature_dim=24, input_dim=6, num_basis=NB, u_max=(1.0,) * 6, target_traj=_traj())
    jp, tp = jpol.SumOfGaussiansTracking(**kw), tpol.SumOfGaussiansTracking(**kw)
    rng = np.random.default_rng(t)
    params = dict(log_lengthscales=0.3 * rng.standard_normal(24) + 1.0,
                  centers=rng.uniform(-1.5, 1.5, (NB, 24)), weight=rng.standard_normal((6, NB)))
    states = _traj()[0] + 0.1 * rng.standard_normal((P, 12))
    key = jax.random.PRNGKey(t)
    want = jp.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(states), t,
                    key=key if p_drop else None, p_dropout=p_drop)
    keep = None
    if p_drop:
        keep = torch.as_tensor(np.asarray(jax.random.bernoulli(
            key, jnp.maximum(1.0 - jnp.asarray(p_drop), 1e-6), (P, NB))))
    got = tp.apply(to_torch(params, "cpu"), torch.as_tensor(states), t, p_dropout=p_drop,
                   keep=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    if t >= 10:
        np.testing.assert_array_equal(got.numpy(), tp.apply(to_torch(params, "cpu"),
                                      torch.as_tensor(states), 9, p_dropout=p_drop,
                                      keep=keep).numpy())


@pytest.mark.parametrize("t", [0, 9, 10, 11])
@pytest.mark.parametrize("dither", [False, True])
def test_pd_controller_matches_jax(x64, t, dither):
    """The PD law; with the dither, JAX's draw from fold(key, 0x9D) handed to
    the port.  Past the target, t clamps to its last row."""
    kw = dict(state_dim=12, input_dim=6, target_traj=_traj(), u_max=(1.0,) * 6,
              noise_std=0.05 if dither else 0.0)
    jp, tp = jpol.PDController(**kw), tpol.PDController(**kw)
    rng = np.random.default_rng(10 + t)
    gains = dict(sqrt_kp=rng.uniform(0.5, 1.5, 6), sqrt_kd=rng.uniform(0.05, 0.2, 6))
    states = _traj()[min(t, 9)] + 0.2 * rng.standard_normal((P, 12))
    key = jax.random.PRNGKey(100 + t)
    want = jp.apply(jax.tree_util.tree_map(jnp.asarray, gains), jnp.asarray(states), t, key=key)
    eps = None
    if dither:
        eps = torch.as_tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(key, 0x9D), (P, 6), jnp.float64)))
    tparams = tp.init_params(None, **gains, dtype=torch.float64)
    got = tp.apply(tparams, torch.as_tensor(states), t, dither=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    if dither:
        # the port's own draw: one per key, a different one per key
        a = tp.apply(tparams, torch.as_tensor(states), t, key=(1, 2))
        b = tp.apply(tparams, torch.as_tensor(states), t, key=(1, 2))
        c = tp.apply(tparams, torch.as_tensor(states), t, key=(1, 3))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not torch.equal(a, tp.apply(tparams, torch.as_tensor(states), t))


@pytest.mark.parametrize("per_trial,trial_index", [(False, 0), (True, 0), (True, 1), (True, 4),
                                                   (True, -1)])
def test_tracking_cost_matches_jax(x64, per_trial, trial_index):
    """An executed trial's T+1 states against the T-step target (the time
    index clamps), and per-trial rows past the schedule (the trial index
    clamps)."""
    ls = np.array([[2.0] * 6 + [4.0] * 6, [0.5] * 6 + [1.0] * 6]) if per_trial else \
        np.array([0.5] * 6 + [1.0] * 6)
    kw = dict(target_traj=_traj(), lengthscales=ls, per_trial=per_trial,
              used_indices=tuple(range(12)))
    jc, tc = jcosts.SaturatedTrajectoryTracking(**kw), tcosts.SaturatedTrajectoryTracking(**kw)
    rng = np.random.default_rng(3)
    states = _traj(12)[:, None, :] + 0.3 * rng.standard_normal((12, P, 12))
    inputs = rng.standard_normal((12, P, 6))
    want = jc.stage_costs(jnp.asarray(states), jnp.asarray(inputs), jnp.asarray(trial_index))
    got = tc.stage_costs(torch.as_tensor(states), torch.as_tensor(inputs), trial_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    for w, g in zip(jc(jnp.asarray(states), jnp.asarray(inputs), trial_index),
                    tc(torch.as_tensor(states), torch.as_tensor(inputs), trial_index)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-12)
    # used_indices: the velocity dims left out of the cost do not move it
    part = dataclasses.replace(tc, used_indices=tuple(range(6)))
    moved = states.copy()
    moved[..., 6:] += 5.0
    np.testing.assert_array_equal(part.stage_costs(torch.as_tensor(moved), None).numpy(),
                                  part.stage_costs(torch.as_tensor(states), None).numpy())


# -------------------------------------------------------------- rollout


def _asset_data(model, rows=64):
    """The first ``rows`` training pairs of the recorded trial 0, padded to
    a bucket of 64 more."""
    tr = tur5.recorded_trials()
    x, y = model.training_pairs(torch.as_tensor(tr["measured"][0], dtype=torch.float64),
                                torch.as_tensor(tr["inputs"][0], dtype=torch.float64))
    x, y = x.numpy()[:rows], y.numpy()[:, :rows]
    cap = rows + 64
    xp, yp = np.zeros((cap, x.shape[1])), np.zeros((y.shape[0], cap))
    xp[:rows], yp[:, :rows] = x, y
    return xp, yp, (np.arange(cap) < rows).astype(np.float64)


@pytest.fixture(scope="module")
def ur5_rollout():
    """Both packages' UR5 engines and costs at a tiny width, a float64 GP
    posterior on the recorded data, the policy params (weights x25, so that
    the policy moves the particles within 8 steps) and particles started
    off the target (cost off its plateau and off zero)."""
    with jax.enable_x64():
        jagent, _ = jur5.build(_cfg(jur5))
        tagent, _ = tur5.build(_cfg(tur5), "cpu")
        x, y, mask = _asset_data(tagent.model)
        params = jagent.gp.init_params(sigma_n=0.05, dtype=jnp.float64)
        post = jagent.gp.fit_posterior(params, jgp.GPData(*(jnp.asarray(a) for a in (x, y, mask))))
        pol = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jagent.policy_params)
        pol = dict(pol, weight=25.0 * pol["weight"])
        s0 = np.asarray(jagent.cost.target_traj)[0] + 0.15 * np.random.default_rng(0) \
            .standard_normal((P, 12))
        return dict(jagent=jagent, tagent=tagent, params=params, post=post, pol=pol, s0=s0,
                    t=dict(gp=to_torch(_np(params), "cpu", into=tgp.GPParams),
                           post=to_torch(_np(post), "cpu", into=tgp.Posterior),
                           pol=to_torch(_np(pol), "cpu")))


@pytest.mark.parametrize("remat", [True, False])
def test_rollout_cost_and_gradient_match_jax(ur5_rollout, remat):
    """8 noisy steps with dropout 0.25 from one key, JAX's engine with
    remat=True; the port with remat on and off."""
    r = ur5_rollout
    jengine = r["jagent"].optimizer.engine
    assert jengine.remat and jengine.bptt_clip == 1.0 and jengine.delta_cap == 3.0
    key, p_drop = jax.random.PRNGKey(5), 0.25
    with jax.enable_x64():
        def cost_j(pp):
            res = jengine.simulate(key, pp, r["params"], r["post"], jnp.asarray(r["s0"]), T,
                                   p_dropout=p_drop)
            return r["jagent"].cost(res.states, res.inputs)[0]

        cj, gj = jax.jit(jax.value_and_grad(cost_j))(r["pol"])
        noise = jax_rollout_noise(key, P, T, 6, NB, p_drop, dtype=jnp.float64)
    tengine = dataclasses.replace(r["tagent"].optimizer.engine, remat=remat)
    leaves = {k: v.clone().requires_grad_(True) for k, v in r["t"]["pol"].items()}
    res = tengine.simulate(None, leaves, r["t"]["gp"], r["t"]["post"], torch.as_tensor(r["s0"]),
                           T, p_dropout=p_drop, noise=noise)
    ct, _ = r["tagent"].cost(res.states, res.inputs)
    gt = torch.autograd.grad(ct, list(leaves.values()))
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-9)
    assert 0.05 * T < ct.item() < 0.95 * T  # off the saturated plateau
    for name, g in zip(leaves, gt):
        want = np.asarray(gj[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(want).max()), err_msg=name)


@pytest.fixture(scope="module")
def fitted_p2():
    """The port's UR5 at poly_degree=2 on the recorded trials, 3 fit epochs
    (the SOD selection over 400 points takes most of its ~8 s)."""
    agent, _ = tur5.build(_cfg(tur5, poly_degree=2, T_control=0.2), "cpu")
    tr = tur5.recorded_trials()
    for i in range(2):
        agent.add_external_trial(tr["measured"][i], tr["inputs"][i], exploration=True)
    info = agent.fit_model(ModelFitOptions(num_epochs=3))
    return agent, info


def test_remat_gradient_is_bitwise_the_plain_one_and_runs_k1_twice(fitted_p2):
    """One rollout's policy gradient from one key, remat on and off: bitwise
    equal.  Through the kernels' structure ('se+p2', their plain versions on
    the CPU, counted), remat runs K1 once in the forward and once in the
    recompute per step, K2 once.  The cost's lengthscales are widened to
    100, so that the 3-epoch model's particles stay off the saturated
    plateau and the gradient is not zero."""
    agent, _ = fitted_p2
    assert agent.gp._fused_structure() == "se+p2"
    counts = {"fwd": 0, "bwd": 0}
    real = (fp.reference_gram_contract, fp.reference_gram_contract_bwd_xstar)

    def counted(i, k):
        def fn(*a, **kw):
            counts[k] += 1
            return real[i](*a, **kw)
        return fn

    out = {}
    with mock.patch.object(MultiGP, "predict", MultiGP._predict_fused), \
            mock.patch.object(fp, "reference_gram_contract", counted(0, "fwd")), \
            mock.patch.object(fp, "reference_gram_contract_bwd_xstar", counted(1, "bwd")):
        for remat in (True, False):
            opt = dataclasses.replace(
                agent.optimizer, cost=dataclasses.replace(agent.cost, lengthscales=(100.0,) * 12),
                engine=dataclasses.replace(agent.optimizer.engine, remat=remat))
            leaves = {k: v[None].detach().clone().requires_grad_(True)
                      for k, v in agent.policy_params.items()}
            counts.update(fwd=0, bwd=0)
            cost, _ = opt._rollout_cost(leaves, agent.gp_params, agent.posterior,
                                        [tprng.root_key(3)], 0.25, 0)
            grads = torch.autograd.grad(cost.sum(), list(leaves.values()))
            out[remat] = (cost, grads, dict(counts))
    steps = agent.optimizer.horizon - 1
    assert out[True][2] == {"fwd": 2 * steps, "bwd": steps}
    assert out[False][2] == {"fwd": steps, "bwd": steps}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b) and float(a.abs().max()) > 0


# ------------------------------------------------------- build and the asset


def test_build_matches_jax_field_by_field():
    cfg_j, cfg_t = jur5.UR5Config(), tur5.UR5Config()
    as_json = lambda c: json.loads(json.dumps(dataclasses.asdict(c), default=str))
    assert as_json(cfg_t) == as_json(cfg_j) and as_json(cfg_t.smoke()) == as_json(cfg_j.smoke())
    for kw in ({}, dict(poly_degree=2, cost_lengthscales="curriculum", delta_cap=None)):
        jagent, jkw = jur5.build(_cfg(jur5, **kw))
        tagent, tkw = tur5.build(_cfg(tur5, **kw), "cpu")
        for attr in ("model", "gp", "policy", "exploration_policy", "cost", "plant", "init_dist",
                     "optimizer", "sod", "sor", "dt", "seed", "offline_filtering",
                     "fixed_initial_state", "scenario_name"):
            assert_same_config(getattr(jagent, attr), getattr(tagent, attr), attr)
        assert as_json(tagent.scenario_config) == as_json(jagent.scenario_config)
        assert_same_config(jkw["model_fit_options"], tkw["model_fit_options"])
        assert_same_config(jkw["policy_opt_options"], tkw["policy_opt_options"])
        assert {k: v for k, v in jkw.items() if "options" not in k} == \
            {k: v for k, v in tkw.items() if "options" not in k}
        # the PD gains are set; the policy init is drawn (another generator)
        # within the same ranges
        for k, v in jagent.expl_params.items():
            np.testing.assert_array_equal(tagent.expl_params[k].numpy(), np.asarray(v))
        p = {k: v.numpy() for k, v in tagent.policy_params.items()}
        assert {k: v.shape for k, v in p.items()} == \
            {k: np.asarray(v).shape for k, v in jagent.policy_params.items()}
        np.testing.assert_allclose(np.exp(p["log_lengthscales"]), np.pi, rtol=1e-6)
        assert np.abs(p["centers"][:, :12]).max() <= np.pi / 2
        assert np.abs(p["centers"][:, 12:]).max() <= 0.1
        assert np.abs(p["weight"]).max() <= 0.02
        assert tagent.optimizer.engine.remat and tagent.optimizer.chunk_steps == 100


def test_recorded_asset_shapes_and_dataset():
    """Two PD-exploration trials of 4 s at 50 Hz: 201 samples each (the
    final input sample included), N = 400 training pairs, and the same
    pairs as the JAX model makes of them."""
    tr = tur5.recorded_trials()
    assert {k: (v.shape, v.dtype) for k, v in tr.items()} == {
        "measured": ((2, 201, 12), np.float32), "true": ((2, 201, 12), np.float32),
        "inputs": ((2, 201, 6), np.float32)}
    assert np.all(np.isfinite(tr["measured"])) and np.abs(tr["inputs"]).max() < 1.0
    agent, _ = tur5.build(_cfg(tur5), "cpu")
    jagent, _ = jur5.build(_cfg(jur5))
    for i in range(2):
        agent.add_external_trial(tr["measured"][i], tr["inputs"][i], exploration=True)
        jagent.add_external_trial(tr["measured"][i], tr["inputs"][i], exploration=True)
    assert agent.gp_x.shape == (400, 24) and agent.num_exploration_trials == 2
    np.testing.assert_allclose(agent.gp_x, jagent.gp_x, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(agent.gp_y, jagent.gp_y, rtol=1e-6, atol=1e-7)


def test_asset_re_records_bitwise(tmp_path):
    pytest.importorskip("mujoco")
    got = tur5.record_ur5_trials(str(tmp_path / "t.npz"), num_trials=1)
    want = tur5.recorded_trials()
    for k in ("measured", "inputs", "true"):
        np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=k)


def test_fit_and_two_steps_from_the_recorded_asset(fitted_p2):
    """The HIL path: both trials in through add_external_trial, a fit (SOD
    keeps all 400 points in every head, padded M = 448), then two optimizer
    steps with finite costs."""
    agent, info = fitted_p2
    assert info["num_samples"] == 400 and agent.posterior.x_tr.shape == (448, 24)
    assert len(info["sod_points"]) == 6 and all(0 < n <= 400 for n in info["sod_points"])
    log = agent.improve_policy(PolicyOptOptions(opt_steps=2, learning_rate=0.01, p_dropout=0.25), 0)
    assert log.steps_done == 2 and np.all(np.isfinite(log.cost_history))
    assert log.particles_states.shape == (agent.optimizer.horizon, P, 12)
    assert all(torch.all(torch.isfinite(v)) for v in agent.policy_params.values())


# --------------------------------------------------------- scripts


def test_plateau_rescue_fires_on_a_forced_plateau(tmp_path, capsys):
    """With the plateau threshold at 0 every trial 0 is a plateau: the run
    restarts once with the cost curriculum in ``<log dir>_rescue``; a
    threshold above any cost leaves the run alone."""
    pytest.importorskip("mujoco")
    from mcpilco_tpu_torch.scripts import train_ur5

    base = _cfg(tur5, opt_steps=(2,), gp_epochs=5, T_control=0.2,
                log_dir=str(tmp_path / "run"))
    agent, _ = train_ur5.run(dataclasses.replace(base, plateau_rescue_frac=0.0), "cpu")
    out = capsys.readouterr().out
    assert "PLATEAU" in out and "rescue_fired: True" in out
    assert agent.scenario_config.cost_lengthscales == "curriculum"
    assert agent.cost.per_trial and os.path.isdir(tmp_path / "run_rescue" / "complete_trial0")
    agent, _ = train_ur5.run(dataclasses.replace(base, plateau_rescue_frac=1e9, log_dir=None),
                             "cpu")
    out = capsys.readouterr().out
    assert "PLATEAU" not in out and "rescue_fired: False" in out
    assert agent.scenario_config.cost_lengthscales == "fixed"
    assert "tracking error (deg)" in out and len(agent.trial_logs) == 1


def test_repeat_farm_refuses_ur5_and_apply_policy_replays_a_ur5_checkpoint(tmp_path, capsys):
    from mcpilco_tpu_torch.scripts import apply_policy, repeat

    with pytest.raises(SystemExit, match="does not take ur5"):
        repeat.main(["--scenario", "ur5", "--farm", "--num-seeds", "1", "--device", "cpu"])
    agent, _ = tur5.build(_cfg(tur5, log_dir=str(tmp_path)), "cpu")
    tr = tur5.recorded_trials()
    agent.add_external_trial(tr["measured"][0][:41], tr["inputs"][0][:41], exploration=True)
    agent.fit_model(ModelFitOptions(num_epochs=5))
    agent.save_checkpoint("model_trial0")
    assert apply_policy.main([str(tmp_path / "model_trial0"), "--target", "model", "--repeats",
                              "4", "--T", "0.2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rebuilt 'ur5' from checkpoint config" in out
    assert "model: 4 particles x 10 steps" in out and "nan" not in out.lower()


# ------------------------------------------------------- checkpoints


def _named(tree, package):
    if package == "jax":
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = tuple(getattr(p, "key", getattr(p, "name", getattr(p, "idx", None)))
                         for p in path)
            out[name] = np.asarray(leaf)
        return out
    return {p: tckpt._to_numpy(l) for p, l in tckpt.flatten_with_path(tree)}


def _assert_named_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_written_by_one_package_resumes_in_the_other(writer, tmp_path):
    """A UR5 run of one trial of 41 recorded samples, a 5-epoch fit and a
    trial log, saved as ``complete_trial0`` by ``writer``; the other package
    auto-resumes it (the stored configs compare equal) with every array
    bitwise the writer's."""
    cfg = dict(log_dir=str(tmp_path))
    tr = tur5.recorded_trials()
    measured, inputs = tr["measured"][0][:41], tr["inputs"][0][:41]
    if writer == "port":
        src, _ = tur5.build(_cfg(tur5, **cfg), "cpu")
        src.add_external_trial(measured, inputs, exploration=True)
        src.fit_model(ModelFitOptions(num_epochs=5))
        src.improve_policy(PolicyOptOptions(opt_steps=1, p_dropout=0.25), 0)
        dst, _ = jur5.build(_cfg(jur5, **cfg))
    else:
        src, _ = jur5.build(_cfg(jur5, **cfg))
        src.add_external_trial(measured, inputs, exploration=True)
        src.fit_model(JFit(num_epochs=5))
        rng = np.random.default_rng(0)
        src.trial_logs.append(JTrialLog(
            cost_history=rng.random(1, dtype=np.float32),
            std_history=rng.random(1, dtype=np.float32),
            steps_done=1, particles_states=rng.random((50, P, 12), dtype=np.float32),
            particles_inputs=rng.random((50, P, 6), dtype=np.float32), reinit_count=0,
            wall_clock_s=0.5))
        dst, _ = tur5.build(_cfg(tur5, **cfg), "cpu")
    src.save_checkpoint("complete_trial0")
    assert dst.auto_resume() == 1
    other = "jax" if writer == "port" else "port"
    for tree in ("gp_params", "policy_params", "expl_params"):
        _assert_named_equal(_named(getattr(dst, tree), other), _named(getattr(src, tree), writer))
    np.testing.assert_array_equal(dst.gp_x, src.gp_x)
    np.testing.assert_array_equal(dst.gp_y, src.gp_y)
    assert dst.num_exploration_trials == 1 and dst.num_collections == 1
    for f in ("cost_history", "particles_states", "particles_inputs"):
        np.testing.assert_array_equal(getattr(dst.trial_logs[0], f), getattr(src.trial_logs[0], f))
    # a changed field refuses the resume in the other package too
    refuse = (tur5.build(_cfg(tur5, poly_degree=2, **cfg), "cpu")[0] if other == "port"
              else jur5.build(_cfg(jur5, poly_degree=2, **cfg))[0])
    with pytest.raises(RuntimeError, match="poly_degree"):
        refuse.auto_resume()


def test_repeat_scores_a_ur5_seed_by_its_tracking_error(tmp_path, monkeypatch, capsys):
    """Sequential ``repeat --scenario ur5``: a seed whose final trial tracks
    the target within 10 degrees RMS succeeds, one 0.3 rad off fails; the
    summary keeps the cumulative cost."""
    from mcpilco_tpu_torch.control.mc_pilco import TrialData
    from mcpilco_tpu_torch.scripts import repeat, train_ur5

    monkeypatch.chdir(tmp_path)

    def fake_run(cfg, device, auto_resume=False):
        agent, _ = tur5.build(dataclasses.replace(cfg, log_dir=None), device)
        traj = np.asarray(agent.cost.target_traj, np.float32)
        true = np.concatenate([traj, traj[-1:]]) + (0.3 if cfg.seed == 2 else 0.0)
        agent.trials.append(TrialData(true, np.zeros((len(true), 6), np.float32), true, true))
        return agent, 0

    monkeypatch.setattr(train_ur5, "run", fake_run)
    assert repeat.main(["--scenario", "ur5", "--num-seeds", "2", "--smoke", "--device",
                        "cpu"]) == 0
    with open(os.path.join("results_tmp", "torch", "repeat_ur5.json")) as f:
        summary = json.load(f)
    assert summary["per_seed"] == {"1": True, "2": False}
    assert summary["per_seed_cost"]["1"] < 1e-3 < summary["per_seed_cost"]["2"]


def test_scenario_is_registered_in_the_scripts():
    from mcpilco_tpu_torch.scripts import apply_policy, repeat

    assert apply_policy.SCENARIOS["ur5"][0] is tur5
    mod, script, success = repeat.SCENARIOS["ur5"]
    # a seed's config is what its script's flags give: the config's defaults
    cfg, _ = script.parse(["--seed", "3"])
    assert mod is tur5 and dataclasses.replace(cfg, log_dir=None) == tur5.UR5Config(seed=3)
    assert script is importlib.import_module("mcpilco_tpu_torch.scripts.train_ur5")
    assert success is tur5.tracking_success
