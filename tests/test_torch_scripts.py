"""The port's entry scripts (``mcpilco_tpu_torch/scripts``), in process on the
CPU: ``--help`` of each, a smoke training run whose checkpoints feed the
replay, and the repeat protocol sequential and farmed, whose summary has
the keys of the JAX package's ``scripts/repeat.py``."""

import collections
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
           "train_cartpole_mujoco", "apply_policy", "repeat", "profile_opt", "summarize_results",
           "profile_farm", "bench_particle_scaling"]
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
    """The keys of the JAX package's ``_write_summary``, and the port's two
    that say whether a sweep was cut down (``smoke``, ``trials``)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    jrepeat = importlib.import_module("repeat")
    args = type("Args", (), dict(scenario="cartpole", out_tag="keys", extra_flag=[],
                                 scenario_kw=[]))()
    summary, _ = jrepeat._write_summary(args, {1: True}, {1: 7.5}, set(), complete=True)
    sys.modules.pop("repeat")
    return set(summary) | {"smoke", "trials"}


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
    """The uncaptured step's host time only, at each swept number of
    iterations per host read: no graph and no device figure without a
    card."""
    out = tmp_path / "profile.json"
    rc = profile_opt.main(["--smoke", "--device", "cpu", "--steps", "2", "--turns", "1",
                           "--epochs", "30", "--chunk", "1,2", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu"
    assert list(report["modes"]) == ["chunk=1", "chunk=2", "uncaptured"]
    # a call of 1 + 2 steps: one read per step, per two, per call
    assert [r["reads_per_call"] for r in report["modes"].values()] == [3, 2, 1]
    for row in report["modes"].values():
        assert len(row["host_ms"]) == 1 and row["host_ms"][0] > 0 and row["busy_ms"] is None
    assert "not measured" in capsys.readouterr().out


@pytest.mark.parametrize("more, fault", [
    (dict(us=300.0, replays=[1000] * 3, replays_run=3), None),
    (dict(us=100.0, replays=[1000] * 3, replays_run=3), "device us"),
    (dict(us=300.0, replays=[1000, 600, 1000], replays_run=3), "graph replays of [600, 1000]"),
    (dict(us=300.0, replays=[1000] * 2, replays_run=3), "2 graph replays seen of 3 run"),
    (dict(us=300.0, replays=[], replays_run=0), None),
], ids=["whole", "no_more_device_time", "short_replay", "replay_missing", "uncaptured"])
def test_window_fault_finds_a_window_short_of_records(more, fault):
    """profile_steps differences run(b) and a longer run: a pair whose
    longer window lost records (the profiler returns one now and then) is
    named, and profiled again."""
    from mcpilco_tpu_torch.utils import profiling

    base = dict(us=100.0, replays=[1000] if more["replays"] else [],
                replays_run=1 if more["replays_run"] else 0)
    got = profiling.window_fault(base, more)
    assert got == fault if fault is None else fault in got


def test_profile_steps_counts_the_steps_run_and_profiles_a_short_window_again(monkeypatch,
                                                                            capsys):
    """The device figures are over the steps the longer run added (here a
    call capped at 4 steps, one more than the base run's 3), and a pair
    whose longer window lost half a replay's records is profiled again.
    The profiler is replaced by records made here: each replay 1,000
    kernels of 1 us, the uncaptured warm-up 50."""
    import torch.profiler
    from mcpilco_tpu_torch.control import trainer
    from mcpilco_tpu_torch.utils import profiling

    state = dict(n=0, profiled=0)

    class Profile(contextlib.nullcontext):
        def __init__(self, *args, **kwargs):
            super().__init__()
            state["profiled"] += 1

    def run(n):
        state["n"] = min(n, 4)
        trainer.graph_counts["uncaptured"] += 1
        trainer.graph_counts["replays"] += state["n"] - 1
        trainer.graph_counts["replays_s"] += 0.02 * (state["n"] - 1)

    def records():
        out = [(10 ** 6 + i, 0, 1000) for i in range(50)]
        for r in range(state["n"] - 1):
            size = 500 if state["profiled"] == 2 and r == 1 else 1000
            out += [(r, 10 ** 7 * r + 2000 * i, 10 ** 7 * r + 2000 * i + 1000)
                    for i in range(size)]
        return out

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(profiling, "device_records", lambda prof: [("k", 1.0)] * len(records()))
    monkeypatch.setattr(profiling, "_replay_records", lambda prof: records())
    monkeypatch.setattr(profiling, "api_calls",
                        lambda prof: collections.Counter(cudaGraphLaunch=state["n"] - 1))
    p = profiling.profile_steps(run, host_steps=3, window=5, base=3)
    assert p["profile_faults"] == ["graph replays of [500, 1000] records"]
    assert "window pair refused" in capsys.readouterr().out
    assert state["profiled"] == 4 and p["steps"] == 1
    assert p["events"] == 1000 and p["api_calls"] == 1 and p["busy_ms"] == 1.0
    assert p["host_ms"] == pytest.approx(20.0) and p["replays_seen"] == 3
    assert p["gap_ms"] == pytest.approx(1.0 * 999 / 1e3)


def test_replay_gaps_group_a_replays_kernels_by_their_launch():
    """The idle time inside each graph replay: records grouped by the
    correlation id of their launch, groups of fewer than REPLAY_MIN records
    (kernels issued one by one) left out, overlapping records counted
    once."""
    from mcpilco_tpu_torch.utils import profiling

    n = profiling.REPLAY_MIN
    a = [(7, 1000 * i, 1000 * i + 800) for i in range(n)]  # 200 ns apart
    b = [(8, 10 ** 6 + 2000 * i, 10 ** 6 + 2000 * i + 1000) for i in range(n)]
    b.append((8, 10 ** 6 + 500, 10 ** 6 + 1500))  # overlaps the first two
    eager = [(100 + i, 5000 * i, 5000 * i + 10) for i in range(n)]
    gaps = profiling.replay_gaps(a + b + eager)
    np.testing.assert_allclose(gaps, [0.2 * (n - 1), 1.0 * (n - 1) - 0.5])
