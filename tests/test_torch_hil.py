"""The hardware-in-the-loop workflow on both packages: external trials, the
CSV file protocol, shape checks, the ingest-then-count discipline of the
exploration ordinal, and the policy export (each case of tests/test_hil.py,
run on the JAX package and on the port).

Agents: the 4PMS cart-pole smoke config (offline velocity estimation on),
16 particles, 4 optimizer steps, 40 GP epochs.  Datasets from the same raw
trial: atol 1e-5 across packages (float32 filtering in each), 1e-6 within
the port.  Exported CSVs: the same file names, and contents equal to the
parameters to the text format's precision (rtol 1e-7).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mcpilco_tpu.scenarios import cartpole_pms as jpms
from mcpilco_tpu_torch.scenarios import cartpole_pms as tpms
from mcpilco_tpu_torch.utils import prng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

PACKAGES = ["jax", "port"]


def _agent(package, tmp_path, seed=1, with_plant=True):
    mod = jpms if package == "jax" else tpms
    cfg = dataclasses.replace(mod.CartpolePMSConfig(seed=seed).smoke(), num_particles=16,
                              opt_steps=(4,), gp_epochs=40,
                              log_dir=str(tmp_path / f"hil_{package}_{seed}_{with_plant}"))
    agent, _ = mod.build(cfg) if package == "jax" else mod.build(cfg, "cpu")
    if not with_plant:
        agent.plant = None
    return agent


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw 4PMS exploration trial from the port's plant (what a rig would
    deliver: noisy positions, junk velocities) and the port agent that
    collected it in the loop."""
    src = _agent("port", tmp_path_factory.mktemp("src"))
    k = prng.fold(prng.stream(src.key, prng.STREAM_SYSTEM), 0)
    trial = src.plant.rollout(k, src._sample_x0(0), src.exploration_policy, src.expl_params,
                              2.0, src.dt, device="cpu")
    src.collect(2.0, trial_index=0, exploration=True)
    return trial, src


def test_add_external_trial_end_to_end(raw, tmp_path):
    """The external path trains on the dataset the in-loop collect() built,
    in both packages, and the port's pipeline runs on it."""
    trial, src = raw
    dst = {p: _agent(p, tmp_path, with_plant=False) for p in PACKAGES}
    for agent in dst.values():
        assert agent.offline_filtering
        agent.add_external_trial(np.array(trial.noisy), trial.inputs)
    np.testing.assert_allclose(dst["port"].gp_x, src.gp_x, atol=1e-6)
    np.testing.assert_allclose(dst["port"].gp_y, src.gp_y, atol=1e-6)
    np.testing.assert_allclose(dst["port"].gp_x, dst["jax"].gp_x, atol=1e-5)
    np.testing.assert_allclose(dst["port"].gp_y, dst["jax"].gp_y, atol=1e-5)
    info = dst["port"].fit_model(tpms.ModelFitOptions(num_epochs=40))
    assert np.isfinite(info["mll_last"])
    log = dst["port"].improve_policy(tpms.PolicyOptOptions(opt_steps=4, p_dropout=0.0), 0)
    assert np.all(np.isfinite(log.cost_history))


def _raises(package, tmp_path, exc, *args, **kw):
    agent = _agent(package, tmp_path, with_plant=False)
    with pytest.raises(exc) as info:
        agent.add_external_trial(*args, **kw)
    return str(info.value), agent


def test_shape_errors_are_the_jax_package_s(tmp_path):
    for args in ((np.zeros((10, 3)), np.zeros((10, 1))),
                 (np.zeros((10, 4), np.float32), np.zeros((7, 1)))):
        msgs = [_raises(p, tmp_path, ValueError, *args)[0] for p in PACKAGES]
        assert msgs[0] == msgs[1]
    assert "[T, 4]" in _raises("port", tmp_path, ValueError, np.zeros((10, 3)),
                               np.zeros((10, 1)))[0]


@pytest.mark.parametrize("package", PACKAGES)
def test_rejected_trial_does_not_bump_exploration_ordinal(package, tmp_path):
    _, agent = _raises(package, tmp_path, ValueError, np.zeros((10, 3)), np.zeros((10, 1)),
                       exploration=True)
    assert agent.num_exploration_trials == 0
    agent.add_external_trial(np.zeros((10, 4), np.float32), np.zeros((10, 1)), exploration=True)
    assert agent.num_exploration_trials == 1


@pytest.mark.parametrize("package", PACKAGES)
def test_failing_collect_does_not_bump_exploration_ordinal(package, tmp_path):
    agent = _agent(package, tmp_path)

    class ExplodingPlant:
        def rollout(self, *a, **k):
            raise RuntimeError("rig disconnected mid-trial")

    agent.plant = ExplodingPlant()
    with pytest.raises(RuntimeError, match="rig disconnected"):
        agent.collect(2.0, trial_index=0, exploration=True)
    assert agent.num_exploration_trials == 0
    assert agent.num_collections == 0


def test_load_external_trial_csv_protocol(raw, tmp_path):
    """<log_dir>/DATA_<trial>/{noisy_samples,input_samples}.csv, ingested the
    same by both packages; DATA_0 counts as exploration."""
    trial, src = raw
    dst = {}
    for p in PACKAGES:
        agent = _agent(p, tmp_path, seed=2, with_plant=False)
        data_dir = os.path.join(agent.log_dir, "DATA_0")
        os.makedirs(data_dir)
        np.savetxt(os.path.join(data_dir, "noisy_samples.csv"), trial.noisy, delimiter=",")
        np.savetxt(os.path.join(data_dir, "input_samples.csv"), trial.inputs, delimiter=",")
        loaded = agent.load_external_trial(exploration=True)
        assert agent.num_collections == 1 and agent.num_exploration_trials == 1
        assert loaded.measured.shape[1] == 4
        dst[p] = agent
    np.testing.assert_allclose(dst["port"].gp_x, src.gp_x, atol=1e-5)
    np.testing.assert_allclose(dst["port"].gp_x, dst["jax"].gp_x, atol=1e-5)
    np.testing.assert_allclose(dst["port"].gp_y, dst["jax"].gp_y, atol=1e-5)


def test_load_external_trial_missing_files(tmp_path):
    msgs = []
    for p in PACKAGES:
        agent = _agent(p, tmp_path, with_plant=False)
        with pytest.raises(FileNotFoundError, match="noisy_samples.csv") as info:
            agent.load_external_trial(data_dir=str(tmp_path / "nowhere"))
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_export_policy_csv_matches_jax(tmp_path):
    """The same file names in the same order, with the same contents, for
    the JAX agent's policy carried across with ``to_torch``."""
    jagent = _agent("jax", tmp_path)
    tagent = _agent("port", tmp_path)
    tagent.policy_params = to_torch(jax.tree_util.tree_map(np.asarray, jagent.policy_params),
                                    "cpu")
    jpaths = jagent.export_policy_csv(str(tmp_path / "jax_csv"))
    tpaths = tagent.export_policy_csv(str(tmp_path / "port_csv"))
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    assert len(tpaths) == 3
    leaves = jax.tree_util.tree_leaves(jagent.policy_params)
    for jp, tp, leaf in zip(jpaths, tpaths, leaves):
        got = np.loadtxt(tp, delimiter=",")
        np.testing.assert_array_equal(got, np.loadtxt(jp, delimiter=","))
        np.testing.assert_allclose(got.reshape(np.shape(leaf)), np.asarray(leaf), rtol=1e-7)
    # with no out_dir the files go to the log dir
    assert os.path.dirname(tagent.export_policy_csv()[0]) == tagent.log_dir
