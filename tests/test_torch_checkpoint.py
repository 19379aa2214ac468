"""Checkpoints and auto-resume: the port against the JAX package.

The layout is the JAX package's (``manifest.json`` plus one npz of
``leaf_0 ... leaf_{n-1}`` per tree, leaves in ``jax.tree_util.tree_flatten``
order), so a directory written by either package loads in the other.  Every
comparison is by leaf name (path), never by count: a port that wrote dict
leaves in insertion order would load in itself and swap arrays in JAX.

Agents use the flagship's smoke config cut further (16 particles, 10 basis
functions, 3 optimizer steps, 30 GP epochs), seed 3.  Restored arrays are
bitwise equal.  The posterior a package rebuilds from a checkpoint predicts
at the dataset inputs within rtol 1e-4 / atol 1e-5 of the other package's
(float32 Cholesky and solves in two frameworks).  A resumed trial on the
CPU matches the unbroken run's within 1e-6 relative.
"""

import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpilco_tpu.control.mc_pilco import ModelFitOptions as JFit
from mcpilco_tpu.control.mc_pilco import TrialLog as JTrialLog
from mcpilco_tpu.scenarios import cartpole as jcp
from mcpilco_tpu.utils import checkpoint as jckpt
from mcpilco_tpu_torch.scenarios import cartpole as tcp
from mcpilco_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRED_TOL = dict(rtol=1e-4, atol=1e-5)


def tiny(mod, log_dir=None, **kw):
    """The same tiny cart-pole config in either package (``mod``)."""
    kw = dict(dict(num_particles=16, opt_steps=(3,), gp_epochs=30, num_basis=10), **kw)
    return dataclasses.replace(mod.CartpoleConfig(seed=3).smoke(),
                               log_dir=None if log_dir is None else str(log_dir), **kw)


def tbuild(log_dir=None, **kw):
    return tcp.build(tiny(tcp, log_dir, **kw), "cpu")


def jbuild(log_dir=None, **kw):
    return jcp.build(tiny(jcp, log_dir, **kw))


def jax_named(tree):
    """{path: array} of a JAX tree, the path as the port's flatten_with_path
    spells it."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "name", getattr(p, "idx", None))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def port_named(tree):
    return {p: tckpt._to_numpy(l) for p, l in tckpt.flatten_with_path(tree)}


def assert_named_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def assert_logs_equal(a, b):
    assert len(a) == len(b)
    for l1, l2 in zip(a, b):
        for f in ("cost_history", "std_history", "particles_states", "particles_inputs"):
            np.testing.assert_array_equal(getattr(l1, f), getattr(l2, f))
        assert (l1.steps_done, l1.reinit_count, l1.wall_clock_s) == \
            (l2.steps_done, l2.reinit_count, l2.wall_clock_s)


def predictions(agent, x, package):
    if package == "jax":
        m, v = agent.gp.predict(agent.gp_params, agent.posterior, jnp.asarray(x))
        return np.asarray(m), np.asarray(v)
    with torch.no_grad():
        m, v = agent.gp.predict(agent.gp_params, agent.posterior, torch.as_tensor(x))
    return m.numpy(), v.numpy()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's tiny config: 2 trials unbroken, and 1 trial (a run
    interrupted after trial 0) in another log dir."""
    root = tmp_path_factory.mktemp("port_runs")
    full, _ = tbuild(root / "full")
    full.reinforce(**{**tbuild()[1], "num_trials": 2}, verbose=False)
    cut, kwargs = tbuild(root / "cut")
    cut.reinforce(**{**kwargs, "num_trials": 1}, verbose=False)
    return dict(full=full, cut=cut, root=root)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX agent of the same config: one exploration trial, a 30-epoch fit,
    one stand-in trial log, saved as ``complete_trial0``."""
    root = tmp_path_factory.mktemp("jax_run")
    agent, _ = jbuild(root)
    agent.collect(3.0, trial_index=0, exploration=True)
    agent.fit_model(JFit(num_epochs=30))
    rng = np.random.default_rng(0)
    agent.trial_logs.append(JTrialLog(
        cost_history=rng.random(3, dtype=np.float32), std_history=rng.random(3, dtype=np.float32),
        steps_done=3, particles_states=rng.random((60, 16, 4), dtype=np.float32),
        particles_inputs=rng.random((60, 16, 1), dtype=np.float32), reinit_count=0,
        wall_clock_s=1.25))
    agent.save_checkpoint("complete_trial0")
    return agent, str(root / "complete_trial0")


class Pair(NamedTuple):
    first: object
    second: object


def test_layout_round_trip_is_bitwise_in_jax_leaf_order(tmp_path):
    """Sorted dict keys, NamedTuple fields and sequence items in order, None
    holding no leaf, an empty dict writing an npz of no arrays; tensors that
    need a gradient detached; the leaf order is jax.tree_util's."""
    rng = np.random.default_rng(1)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    np_tree = {"zeta": arr(3), "alpha": Pair(arr(2, 2), [arr(1), None, (arr(4), arr(5))]),
               "mid": {"b": np.arange(3), "a": np.float32(2.5)}}
    torch_tree = {"zeta": torch.tensor(np_tree["zeta"], requires_grad=True),
                  "alpha": Pair(torch.tensor(np_tree["alpha"].first),
                                [torch.tensor(np_tree["alpha"].second[0]), None,
                                 tuple(torch.tensor(a) for a in np_tree["alpha"].second[2])]),
                  "mid": {"b": torch.arange(3), "a": torch.tensor(np.float32(2.5))}}
    tckpt.save(str(tmp_path), {"tree": torch_tree, "empty": {}}, {"k": 1})
    with np.load(tmp_path / "tree.npz") as data:
        written = [data[f"leaf_{i}"] for i in range(len(data.files))]
    with np.load(tmp_path / "empty.npz") as data:
        assert len(data.files) == 0
    want = jax.tree_util.tree_leaves(np_tree)
    assert len(written) == len(want) == 7
    for w, j in zip(written, want):
        np.testing.assert_array_equal(w, j)
    trees, meta = tckpt.load(str(tmp_path), {"tree": torch_tree, "empty": {}}, "cpu")
    assert meta == {"k": 1} and trees["empty"] == {}
    assert_named_equal(port_named(trees["tree"]), port_named(torch_tree))
    assert trees["tree"]["alpha"].second[1] is None
    assert isinstance(trees["tree"]["alpha"], Pair)
    assert not trees["tree"]["zeta"].requires_grad
    # and JAX's load reads the same arrays into the numpy template
    j_trees, _ = jckpt.load(str(tmp_path), {"tree": np_tree, "empty": {}})
    assert_named_equal(jax_named(j_trees["tree"]), jax_named(np_tree))
    assert tckpt.peek_meta(str(tmp_path)) == jckpt.peek_meta(str(tmp_path)) == {"k": 1}
    tckpt.save_meta(str(tmp_path / "m"), {"a": (1, 2.5), "p": tmp_path})
    assert tckpt.load_meta(str(tmp_path / "m")) == jckpt.load_meta(str(tmp_path / "m")) == \
        {"a": [1, 2.5], "p": str(tmp_path)}


def test_jax_checkpoint_loads_in_port(jax_run):
    jagent, path = jax_run
    tagent, _ = tbuild()
    tagent.load_checkpoint(path)
    assert_named_equal(port_named(tagent.gp_params), jax_named(jagent.gp_params))
    assert_named_equal(port_named(tagent.policy_params), jax_named(jagent.policy_params))
    np.testing.assert_array_equal(tagent.gp_x, jagent.gp_x)
    np.testing.assert_array_equal(tagent.gp_y, jagent.gp_y)
    assert tagent.num_collections == 1 and tagent.num_exploration_trials == 1
    np.testing.assert_array_equal(tagent.trials[0].noisy, jagent.trials[0].noisy)
    assert_logs_equal(tagent.trial_logs, jagent.trial_logs)
    for got, want in zip(predictions(tagent, jagent.gp_x, "port"),
                         predictions(jagent, jagent.gp_x, "jax")):
        np.testing.assert_allclose(got, want, **PRED_TOL)


def test_port_checkpoint_loads_in_jax(port_runs):
    src = port_runs["cut"]
    path = str(port_runs["root"] / "cut" / "complete_trial0")
    jagent, _ = jbuild()
    jagent.load_checkpoint(path)
    assert_named_equal(jax_named(jagent.gp_params), port_named(src.gp_params))
    assert_named_equal(jax_named(jagent.policy_params), port_named(src.policy_params))
    np.testing.assert_array_equal(jagent.gp_x, src.gp_x)
    np.testing.assert_array_equal(jagent.gp_y, src.gp_y)
    assert jagent.num_collections == src.num_collections == 2
    assert_logs_equal(jagent.trial_logs, src.trial_logs)
    # the posterior each package rebuilds from the checkpoint (the full
    # dataset, the control trial included)
    tagent, _ = tbuild()
    tagent.load_checkpoint(path)
    for got, want in zip(predictions(tagent, src.gp_x, "port"),
                         predictions(jagent, src.gp_x, "jax")):
        np.testing.assert_allclose(got, want, **PRED_TOL)


def test_auto_resume_continues_an_interrupted_run(port_runs, tmp_path):
    full, cut = port_runs["full"], port_runs["cut"]
    shutil.copytree(port_runs["root"] / "cut", tmp_path / "cut")
    agent, kwargs = tbuild(tmp_path / "cut")
    assert agent.auto_resume() == 1
    assert agent.num_collections == cut.num_collections
    assert_named_equal(port_named(agent.gp_params), port_named(cut.gp_params))
    assert_named_equal(port_named(agent.policy_params), port_named(cut.policy_params))
    assert_logs_equal(agent.trial_logs, cut.trial_logs)
    logs = agent.reinforce(**{**kwargs, "num_trials": 1}, verbose=False)
    assert len(logs) == 2
    assert os.path.isdir(tmp_path / "cut" / "complete_trial1")
    # the resumed trial is the unbroken run's trial 1
    np.testing.assert_allclose(logs[1].cost_history, full.trial_logs[1].cost_history, rtol=1e-6)
    for k, v in full.policy_params.items():
        np.testing.assert_allclose(agent.policy_params[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(agent.trials[-1].true, full.trials[-1].true, rtol=1e-6, atol=1e-7)


def test_auto_resume_is_a_noop_on_a_fresh_dir(tmp_path):
    assert tbuild(tmp_path / "fresh")[0].auto_resume() == 0
    assert tbuild()[0].auto_resume() == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_auto_resume_refuses_a_changed_config(writer, port_runs, jax_run):
    path = jax_run[1] if writer == "jax" else str(port_runs["root"] / "cut" / "complete_trial0")
    agent, _ = tbuild(os.path.dirname(path), num_particles=17)
    with pytest.raises(RuntimeError, match="num_particles: checkpoint=16 current=17"):
        agent.auto_resume()


def test_auto_resume_across_packages(port_runs, jax_run):
    """A run of either package resumes in the other: the stored configs
    compare equal, and the restored state is the writer's."""
    jagent, jpath = jax_run
    tagent, _ = tbuild(os.path.dirname(jpath))
    assert tagent.auto_resume() == 1
    np.testing.assert_array_equal(tagent.gp_x, jagent.gp_x)
    src = port_runs["cut"]
    jres, _ = jbuild(port_runs["root"] / "cut")
    assert jres.auto_resume() == 1
    np.testing.assert_array_equal(jres.gp_x, src.gp_x)
    assert_logs_equal(jres.trial_logs, src.trial_logs)


def test_apply_policy_replays_a_jax_checkpoint(jax_run, capsys):
    """The port's replay script rebuilds the scenario from a JAX run's stored
    config and rolls its policy through the rebuilt model."""
    from mcpilco_tpu_torch.scripts import apply_policy

    assert apply_policy.main([jax_run[1], "--target", "model", "--repeats", "3", "--T", "0.5",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rebuilt 'cartpole' from checkpoint config" in out
    assert "model: 3 particles x 10 steps" in out and "nan" not in out.lower()


@pytest.mark.parametrize("name,cls", [("cartpole", "CartpoleConfig"),
                                      ("cartpole_pms", "CartpolePMSConfig"),
                                      ("furuta", "FurutaConfig")])
def test_scenario_configs_compare_equal_across_packages(name, cls):
    """Each scenario stamps the same name and a config whose JSON form is
    the JAX package's, so the resume check passes across packages."""
    jmod = importlib.import_module(f"mcpilco_tpu.scenarios.{name}")
    tmod = importlib.import_module(f"mcpilco_tpu_torch.scenarios.{name}")
    as_json = lambda cfg: json.loads(json.dumps(dataclasses.asdict(cfg), default=str))
    assert as_json(getattr(tmod, cls)()) == as_json(getattr(jmod, cls)())
    assert as_json(getattr(tmod, cls)().smoke()) == as_json(getattr(jmod, cls)().smoke())
    cfg = dataclasses.replace(getattr(tmod, cls)().smoke(), num_particles=8, num_basis=5)
    agent, _ = tmod.build(cfg, "cpu")
    assert (agent.scenario_name, agent.scenario_config) == (name, cfg)


def test_plot_logs_reads_a_port_log_dir(port_runs, tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "plot_logs.py"),
         str(port_runs["root"] / "full"), "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-800:]
    assert os.path.exists(tmp_path / "learning_curves.png")
