"""The port's entry scripts (``mcpilco_tpu_torch/scripts``), in process on the
CPU: ``--help`` of each, a smoke training run whose checkpoints feed the
replay, and the repeat protocol sequential and farmed, whose summary has
the keys of the JAX package's ``scripts/repeat.py``."""

import contextlib
import importlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from mcpilco_tpu_torch.scripts import apply_policy, profile_opt, repeat, train_cartpole

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["train_cartpole", "train_cartpole_pms", "train_furuta", "train_ur5",
           "train_cartpole_mujoco", "apply_policy", "repeat", "profile_opt"]
# repeat's seeds cut to a few seconds each
TINY_KW = ["--scenario-kw", "num_particles=16", "--scenario-kw", "opt_steps=(3,)",
           "--scenario-kw", "gp_epochs=30", "--scenario-kw", "num_basis=10"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_exits_zero(name, capsys):
    mod = importlib.import_module(f"mcpilco_tpu_torch.scripts.{name}")
    with pytest.raises(SystemExit) as info:
        mod.main(["--help"])
    assert info.value.code == 0
    assert "usage" in capsys.readouterr().out.lower()


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """``train_cartpole --smoke --device cpu``: its log dir and output."""
    log_dir = str(tmp_path_factory.mktemp("script_smoke") / "run1")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cartpole.main(["--seed", "1", "--smoke", "--device", "cpu",
                                  "--log-dir", log_dir])
    return rc, log_dir, out.getvalue()


def test_train_smoke_writes_checkpoints_and_scores(smoke_run):
    rc, log_dir, out = smoke_run
    assert rc == 0
    assert sorted(os.listdir(log_dir)) == ["complete_trial0", "model_trial0", "policy_trial0"]
    assert "total wall-clock" in out
    assert "final-trial swing-up success: " in out
    cost = float(out.split("final-trial cumulative cost:")[1].split()[0])
    assert np.isfinite(cost) and cost > 0


@pytest.mark.parametrize("target,expect", [("system", "system: cost over 2 runs"),
                                           ("model", "model: 3 particles x 20 steps")])
def test_apply_policy(smoke_run, target, expect, capsys):
    ckpt = os.path.join(smoke_run[1], "complete_trial0")
    rc = apply_policy.main([ckpt, "--target", target, "--repeats", "2" if target == "system"
                            else "3", "--T", "1.0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and expect in out, out
    assert "rebuilt 'cartpole' from checkpoint config" in out
    assert "nan" not in out.lower()


def _jax_summary_keys(tmp_path, monkeypatch):
    """The keys of the JAX package's ``_write_summary``."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    jrepeat = importlib.import_module("repeat")
    args = type("Args", (), dict(scenario="cartpole", out_tag="keys", extra_flag=[],
                                 scenario_kw=[]))()
    summary, _ = jrepeat._write_summary(args, {1: True}, {1: 7.5}, set(), complete=True)
    sys.modules.pop("repeat")
    return set(summary)


@pytest.mark.parametrize("farm", [False, True])
def test_repeat_two_seeds(farm, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--scenario", "cartpole", "--num-seeds", "2", "--smoke", "--device", "cpu",
            "--out-tag", "t"] + TINY_KW + (["--farm"] if farm else ["--no-farm"])
    assert repeat.main(argv) == 0
    with open(os.path.join("results_tmp", "torch", "repeat_cartpole_t.json")) as f:
        summary = json.load(f)
    assert set(summary) == _jax_summary_keys(tmp_path, monkeypatch)
    assert summary["seeds"] == [1, 2] and summary["complete"]
    assert all(np.isfinite(summary["per_seed_cost"][s]) for s in ("1", "2"))
    q = summary["final_trial_cost_quartiles"]
    assert q["min"] <= q["q25"] <= q["median"] <= q["q75"] <= q["max"]
    if not farm:
        # each sequential seed logged its checkpoints in its own dir
        assert os.path.isdir(os.path.join("results_tmp", "torch", "cartpole_t_2",
                                          "complete_trial0"))
    # --resume skips the finished seeds: nothing trains
    capsys.readouterr()
    monkeypatch.setattr(train_cartpole, "run", lambda *a, **k: pytest.fail("a seed trained"))
    monkeypatch.setattr(repeat, "SeedFarm", lambda *a, **k: pytest.fail("a farm trained"))
    assert repeat.main(argv + ["--resume"]) == 0
    assert "nothing left to run" in capsys.readouterr().out
    with open(os.path.join("results_tmp", "torch", "repeat_cartpole_t.json")) as f:
        assert json.load(f)["per_seed_cost"] == summary["per_seed_cost"]


def test_repeat_farm_refuses_unported_scenarios(tmp_path, monkeypatch):
    """The farm takes every scenario the JAX package's repeat farms; ur5,
    which neither package farms, is refused."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="does not take ur5"):
        repeat.main(["--scenario", "ur5", "--num-seeds", "1", "--farm", "--device", "cpu"])


@pytest.mark.parametrize("scenario", ["cartpole_pms", "furuta", "cartpole_mujoco"])
def test_repeat_farm_takes(scenario, tmp_path, monkeypatch):
    """The farm for every scenario the JAX package's repeat farms: the
    default for the device plants, on request for the MuJoCo plant."""
    if scenario == "cartpole_mujoco":
        pytest.importorskip("mujoco")
    monkeypatch.chdir(tmp_path)
    trained = []
    farm = repeat.SeedFarm
    monkeypatch.setattr(repeat, "SeedFarm", lambda *a, **k: trained.append(1) or farm(*a, **k))
    argv = ["--scenario", scenario, "--num-seeds", "2", "--smoke", "--device", "cpu",
            "--out-tag", "t"] + TINY_KW + (["--farm"] if scenario == "cartpole_mujoco" else [])
    assert repeat.main(argv) == 0 and trained == [1]
    with open(os.path.join("results_tmp", "torch", f"repeat_{scenario}_t.json")) as f:
        summary = json.load(f)
    assert set(summary) == _jax_summary_keys(tmp_path, monkeypatch)
    assert summary["seeds"] == [1, 2] and summary["complete"]
    assert all(np.isfinite(summary["per_seed_cost"][s]) for s in ("1", "2"))


def test_profile_opt_on_the_cpu(tmp_path, capsys):
    """The uncaptured step's host time only: no graph and no device figure
    without a card."""
    out = tmp_path / "profile.json"
    rc = profile_opt.main(["--smoke", "--device", "cpu", "--steps", "2", "--turns", "1",
                           "--epochs", "30", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and list(report["modes"]) == ["uncaptured"]
    row = report["modes"]["uncaptured"]
    assert len(row["host_ms"]) == 1 and row["host_ms"][0] > 0 and row["busy_ms"] is None
    assert "not measured" in capsys.readouterr().out
