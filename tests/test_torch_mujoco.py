"""The MuJoCo plant and the MuJoCo cart-pole: the port against the JAX package.

- ``MujocoPlant``: the same arm or cart-pole, start state and policy
  parameters through both packages' plants with the measurement noise and
  the PD dither off; the simulator runs in float64 and each package's policy
  in float32, so the states agree within 1e-5 (absolute) over the trial.
- ``scenarios/cartpole_mujoco``: the build field by field, the policy init
  within its ranges, ``swingup_success``, a tiny run through the train
  script, and its checkpoints resumed across packages (arrays bitwise).

Tests that step the simulator need ``mujoco`` and skip without it.
"""

import dataclasses
import importlib
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_config
from mcpilco_tpu.envs import mujoco_plant as jmj
from mcpilco_tpu.models import policies as jpol
from mcpilco_tpu.scenarios import cartpole_mujoco as jcm
from mcpilco_tpu_torch.envs import mujoco_plant as tmj
from mcpilco_tpu_torch.envs.trajectories import ur5_joint_trajectory
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.scenarios import cartpole_mujoco as tcm
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

STATE_TOL = dict(rtol=0, atol=1e-5)


def _rollout_both(xml, noise, jpolicy, tpolicy, params, s0, T, dt, sim_timestep):
    jplant = jmj.MujocoPlant(xml=xml, noise_std=noise, sim_timestep=sim_timestep)
    tplant = tmj.MujocoPlant(xml=xml, noise_std=noise, sim_timestep=sim_timestep)
    jt = jplant.rollout(jax.random.PRNGKey(0), s0, jpolicy,
                        jax.tree_util.tree_map(jnp.asarray, params), T, dt)
    tt = tplant.rollout((0,), s0, tpolicy, to_torch(params, "cpu", torch.float32), T, dt,
                        device="cpu")
    return jt, tt


def test_ur5_plant_matches_jax_under_the_pd_law():
    """The UR5 arm under the PD law (dither off), 0.5 s: 25 control steps of
    20 physics sub-steps each."""
    pytest.importorskip("mujoco")
    traj = ur5_joint_trajectory(num_steps=25, dt=0.02)
    kw = dict(state_dim=12, input_dim=6, target_traj=traj, u_max=(1.0,) * 6, noise_std=0.0)
    gains = dict(sqrt_kp=np.ones(6, np.float32), sqrt_kd=0.1 * np.ones(6, np.float32))
    s0 = traj[0] + 0.01
    jt, tt = _rollout_both("ur5.xml", (0.0,) * 12, jpol.PDController(**kw),
                           tpol.PDController(**kw), gains, s0, 0.5, 0.02, 0.001)
    assert tt.measured.shape == (26, 12) and tt.inputs.shape == (26, 6)
    for f in ("measured", "true", "noisy"):
        np.testing.assert_allclose(getattr(tt, f), getattr(jt, f), **STATE_TOL, err_msg=f)
    np.testing.assert_allclose(tt.inputs, jt.inputs, **STATE_TOL)
    assert float(np.abs(tt.true[-1] - tt.true[0]).max()) > 1e-2  # the arm moves
    np.testing.assert_array_equal(tt.measured, tt.true)  # no noise: measured is true


def test_cartpole_plant_matches_jax_under_an_rbf_policy():
    """The MuJoCo cart-pole from hanging under a random RBF policy, 1 s."""
    pytest.importorskip("mujoco")
    kw = dict(feature_dim=5, input_dim=1, num_basis=10, u_max=2.5, angle_indices=(1,),
              non_angle_indices=(0, 2, 3))
    rng = np.random.default_rng(2)
    params = dict(log_lengthscales=np.zeros(5, np.float32),
                  centers=rng.uniform(-2, 2, (10, 5)).astype(np.float32),
                  weight=rng.uniform(-3, 3, (1, 10)).astype(np.float32))
    jt, tt = _rollout_both("cartpole_swingup.xml", (0.0,) * 4,
                           jpol.SumOfGaussiansWithAngles(**kw),
                           tpol.SumOfGaussiansWithAngles(**kw), params,
                           np.array([0.0, np.pi, 0.0, 0.0]), 1.0, 0.05, 0.01)
    assert tt.true.shape == (21, 4) and tt.inputs.shape == (21, 1)
    np.testing.assert_allclose(tt.true, jt.true, **STATE_TOL)
    np.testing.assert_allclose(tt.inputs, jt.inputs, **STATE_TOL)
    assert float(np.abs(tt.true[-1] - tt.true[0]).max()) > 1e-2


def test_plant_noise_is_drawn_per_key_and_the_true_state_stays_clean():
    pytest.importorskip("mujoco")
    plant = tmj.MujocoPlant(xml="cartpole_swingup.xml", noise_std=(0.01,) * 4, sim_timestep=0.01)
    pol = tpol.RandomExploration(state_dim=4, input_dim=1, u_max=2.5)
    s0 = np.array([0.0, np.pi, 0.0, 0.0])
    a = plant.rollout((1,), s0, pol, {}, 2.0, 0.05, device="cpu")
    b = plant.rollout((1,), s0, pol, {}, 2.0, 0.05, device="cpu")
    c = plant.rollout((2,), s0, pol, {}, 2.0, 0.05, device="cpu")
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.inputs, c.inputs)
    noise = (a.measured - a.true).ravel()
    assert 0.007 < noise.std() < 0.013 and abs(noise.mean()) < 0.003
    np.testing.assert_array_equal(a.noisy, a.measured)
    np.testing.assert_allclose(a.true[0], s0, atol=1e-6)


def test_plant_without_mujoco_raises_naming_it():
    plant = tmj.MujocoPlant(xml="ur5.xml")
    with mock.patch.dict(sys.modules, {"mujoco": None}):
        with pytest.raises(ImportError, match="mujoco"):
            plant.rollout((0,), np.zeros(12), None, {}, 0.1, 0.02, device="cpu")


def test_host_policy_matches_jax():
    kw = dict(state_dim=12, input_dim=6, target_traj=ur5_joint_trajectory(5, 0.02),
              u_max=(1.0,) * 6, noise_std=0.05)
    gains = dict(sqrt_kp=np.full(6, 1.2, np.float32), sqrt_kd=np.full(6, 0.3, np.float32))
    jfn = jpol.PDController(**kw).host_policy(jax.tree_util.tree_map(jnp.asarray, gains))
    tfn = tpol.PDController(**kw).host_policy(to_torch(gains, "cpu"))
    rng = np.random.default_rng(0)
    for t in (0.0, 2.2, 4.0, 7.0):
        s = rng.standard_normal(12)
        got, want = tfn(s, t), jfn(s, t)
        assert isinstance(got, np.ndarray) and got.shape == (6,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------- scenarios/cartpole_mujoco


@pytest.mark.parametrize("smoke", [False, True])
def test_cartpole_mujoco_build_matches_jax_field_by_field(smoke):
    """SE+P(2) at >= 1000 fit epochs, SE below (the smoke config); the
    curriculum and the delta cap (which turns output normalization on)."""
    as_json = lambda c: json.loads(json.dumps(dataclasses.asdict(c), default=str))
    for kw in ({}, dict(cost_lengthscales="curriculum", delta_cap=3.0, num_restarts=2)):
        cj, ct = jcm.CartpoleMujocoConfig(**kw), tcm.CartpoleMujocoConfig(**kw)
        if smoke:
            cj, ct = cj.smoke(), ct.smoke()
        assert as_json(ct) == as_json(cj)
        jagent, jkw = jcm.build(cj)
        tagent, tkw = tcm.build(ct, "cpu")
        for attr in ("model", "gp", "policy", "exploration_policy", "cost", "plant", "init_dist",
                     "optimizer", "sod", "sor", "dt", "seed", "scenario_name"):
            assert_same_config(getattr(jagent, attr), getattr(tagent, attr), attr)
        assert_same_config(jkw["policy_opt_options"], tkw["policy_opt_options"])
        assert_same_config(jkw["model_fit_options"], tkw["model_fit_options"])
        p = {k: v.numpy() for k, v in tagent.policy_params.items()}
        assert {k: v.shape for k, v in p.items()} == \
            {k: np.asarray(v).shape for k, v in jagent.policy_params.items()}
        assert np.abs(p["centers"][:, :2]).max() <= 2.0
        assert np.abs(p["centers"][:, 2]).max() <= 2 * np.pi
        np.testing.assert_allclose(p["centers"][:, 3] ** 2 + p["centers"][:, 4] ** 2, 1.0,
                                   rtol=1e-5)
        assert np.abs(p["weight"]).max() <= ct.u_max / 2
        np.testing.assert_array_equal(p["log_lengthscales"], 0.0)
    assert tagent.cost.per_trial and tagent.gp.normalize_outputs


def test_cartpole_mujoco_policy_init_is_per_seed():
    cfg = tcm.CartpoleMujocoConfig().smoke()
    agent, _ = tcm.build(cfg, "cpu")
    a = tcm.policy_init(cfg, agent.policy, tprng.root_key(1), "cpu")
    b = tcm.policy_init(cfg, agent.policy, tprng.root_key(2), "cpu")
    for k in a:
        assert torch.equal(a[k], agent.policy_params[k])
    assert not torch.equal(a["centers"], b["centers"])


def test_swingup_success_matches_jax():
    rng = np.random.default_rng(0)
    up = np.zeros((40, 4))
    cases = [up, up + [0.0, 2 * np.pi, 0, 0], up + [0.0, 0.3, 0, 0], up + [0.6, 0.0, 0, 0],
             up + [0.0, np.pi, 0, 0], 0.05 * rng.standard_normal((40, 4))]
    for s in cases:
        assert tcm.swingup_success(s) == jcm.swingup_success(s)
    assert [tcm.swingup_success(s) for s in cases] == [True, True, False, False, False, True]


def _tiny(mod, log_dir):
    return dataclasses.replace(mod.CartpoleMujocoConfig(seed=2).smoke(), num_basis=10,
                               num_particles=8, opt_steps=(2,), gp_epochs=10, T_exploration=1.0,
                               T_control=1.0, log_dir=str(log_dir))


def test_train_script_runs_and_jax_resumes_the_run(tmp_path, capsys):
    """One trial of the tiny config through ``train_cartpole_mujoco.run`` on
    the CPU (MuJoCo exploration, fit, 2 steps, a control trial); the JAX
    package auto-resumes its ``complete_trial0`` with every array the
    port's."""
    pytest.importorskip("mujoco")
    from mcpilco_tpu_torch.scripts import train_cartpole_mujoco

    agent, done = train_cartpole_mujoco.run(_tiny(tcm, tmp_path), "cpu")
    out = capsys.readouterr().out
    assert done == 0 and "swing-up success" in out and "tail theta" in out
    assert agent.num_collections == 2 and agent.trials[0].true.shape == (21, 4)
    jagent, _ = jcm.build(_tiny(jcm, tmp_path))
    assert jagent.auto_resume() == 1
    np.testing.assert_array_equal(jagent.gp_x, agent.gp_x)
    for k, v in agent.policy_params.items():
        np.testing.assert_array_equal(np.asarray(jagent.policy_params[k]), v.numpy())
    np.testing.assert_array_equal(jagent.trials[-1].true, agent.trials[-1].true)


def test_port_resumes_a_jax_run(tmp_path):
    pytest.importorskip("mujoco")
    from mcpilco_tpu.control.mc_pilco import ModelFitOptions as JFit
    from mcpilco_tpu.control.mc_pilco import TrialLog as JTrialLog

    jagent, _ = jcm.build(_tiny(jcm, tmp_path))
    jagent.collect(1.0, trial_index=0, exploration=True)
    jagent.fit_model(JFit(num_epochs=10))
    rng = np.random.default_rng(0)
    jagent.trial_logs.append(JTrialLog(
        cost_history=rng.random(2, dtype=np.float32), std_history=rng.random(2, dtype=np.float32),
        steps_done=2, particles_states=rng.random((20, 8, 4), dtype=np.float32),
        particles_inputs=rng.random((20, 8, 1), dtype=np.float32), reinit_count=0,
        wall_clock_s=0.5))
    jagent.save_checkpoint("complete_trial0")
    tagent, kwargs = tcm.build(_tiny(tcm, tmp_path), "cpu")
    assert tagent.auto_resume() == 1
    np.testing.assert_array_equal(tagent.gp_x, jagent.gp_x)
    np.testing.assert_array_equal(tagent.trials[0].measured, jagent.trials[0].measured)
    for k, v in jagent.policy_params.items():
        np.testing.assert_array_equal(tagent.policy_params[k].numpy(), np.asarray(v))
    logs = tagent.reinforce(**{**kwargs, "num_trials": 1}, verbose=False)
    assert len(logs) == 2 and logs[1].steps_done == 2
    assert np.all(np.isfinite(logs[1].cost_history)) and tagent.num_collections == 2


def test_scenario_is_registered_in_the_scripts():
    from mcpilco_tpu_torch.scripts import apply_policy, repeat

    assert apply_policy.SCENARIOS["cartpole_mujoco"][0] is tcm
    mod, script, success = repeat.SCENARIOS["cartpole_mujoco"]
    # a seed's config is what its script's flags give: the config's defaults
    cfg, _ = script.parse(["--seed", "4"])
    assert mod is tcm and dataclasses.replace(cfg, log_dir=None) == tcm.CartpoleMujocoConfig(seed=4)
    assert script is importlib.import_module("mcpilco_tpu_torch.scripts.train_cartpole_mujoco")
    # the farm takes the MuJoCo plant on request, as the JAX package's repeat
    assert "cartpole_mujoco" in repeat.FARM_SUPPORTED and "cartpole_mujoco" not in repeat.FARMABLE
