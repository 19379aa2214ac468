"""The port's outcome-protocol tools on the CPU: ``scripts/repeat.py``'s
subprocess seeds, ``--jobs``, the infra markers, the STOP file, the
watchdogs and ``--supervise`` against stub train scripts that print the
result lines (nothing trains); ``summarize_results`` against the JAX
package's script on the same summary files; ``profile_farm`` and
``bench_particle_scaling`` at their CPU sizes."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from mcpilco_tpu_torch.scripts import repeat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A train script: with STUB_OUTCOME success / failure / infra / kernel_fault
# its main prints what such a seed prints; with STUB_STOP it leaves the STOP
# file behind after seed 1.  Its run goes silent for a minute, or with
# STUB_OUTCOME ticking (fitting) runs optimizer iterations (fit epochs) for
# 6 s and prints nothing.
STUB_TRAIN = textwrap.dedent('''
    import argparse, os, sys, time

    def parse(argv=None):
        p = argparse.ArgumentParser()
        for flag in ("--seed", "--trials"):
            p.add_argument(flag, type=int)
        for flag in ("--log-dir", "--device"):
            p.add_argument(flag)
        for flag in ("--smoke", "--auto-resume"):
            p.add_argument(flag, action="store_true")
        args, args.rest = p.parse_known_args(argv)
        return args, args

    class Agent:
        def trial_cumulative_cost(self):
            return 7.25

    def run(cfg, device="cuda", auto_resume=False):
        print("[stub] training seed", cfg.seed, flush=True)
        if os.environ.get("STUB_OUTCOME") not in ("ticking", "fitting"):
            time.sleep(60)
        # an optimization or a fit that prints nothing for 6 s, its
        # iterations or epochs counted
        from mcpilco_tpu_torch.control.trainer import graph_counts
        from mcpilco_tpu_torch.models.gp import fit_counts
        counts, key = ((graph_counts, "replays") if os.environ["STUB_OUTCOME"] == "ticking"
                       else (fit_counts, "epochs"))
        for _ in range(24):
            time.sleep(0.25)
            counts[key] += 1
        return Agent(), 0

    def main(argv=None):
        args, _ = parse(argv)
        outcome = os.environ.get("STUB_OUTCOME", "success")
        print("[stub] seed", args.seed, "flags", args.rest, "resume", args.auto_resume,
              flush=True)
        if outcome in ("success", "failure"):
            ok = outcome == "success"
            print(f"[stub] final-trial swing-up success: {ok}")
            print(f"[stub] final-trial cumulative cost: {7.5 if ok else 30.0:.4f}")
            print("[stub] a line after the cost")
        elif outcome == "infra":
            print("RuntimeError: CUDA error: CUDA-capable device(s) is/are busy or unavailable",
                  file=sys.stderr)
        elif outcome == "kernel_fault":
            print("RuntimeError: CUDA error: an illegal memory access was encountered\\n"
                  "CUDA-capable device(s) is/are busy or unavailable", file=sys.stderr)
        if os.environ.get("STUB_STOP") and args.seed == 1:
            os.makedirs(os.path.dirname(os.environ["STUB_STOP"]), exist_ok=True)
            open(os.environ["STUB_STOP"], "w").close()
        return 0 if outcome == "success" else 1

    if __name__ == "__main__":
        raise SystemExit(main())
''')

# A sweep that exits 87 on its first launch and 0 on its second, or always
# with STUB_RC; each launch appends its argv to launches.txt.
STUB_SWEEP = textwrap.dedent('''
    import os, sys
    with open("launches.txt", "a") as f:
        f.write(" ".join(sys.argv[1:]) + "\\n")
    if "STUB_RC" in os.environ:
        raise SystemExit(int(os.environ["STUB_RC"]))
    raise SystemExit(0 if os.path.exists("stalled") else open("stalled", "w").close() or 87)
''')


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The flagship's train script replaced by STUB_TRAIN, in this process
    and in the seed subprocesses; the sweep runs in ``tmp_path``."""
    (tmp_path / "stub_train.py").write_text(STUB_TRAIN)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH",
                                                                                  ""))
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module("stub_train")
    scen, _, success = repeat.SCENARIOS["cartpole"]
    monkeypatch.setitem(repeat.SCENARIOS, "cartpole", (scen, mod, success))
    yield tmp_path
    sys.modules.pop("stub_train", None)


def _summary(tag="t"):
    with open(os.path.join("results_tmp", "torch", f"repeat_cartpole_{tag}.json")) as f:
        return json.load(f)


ARGV = ["--scenario", "cartpole", "--no-farm", "--device", "cpu", "--out-tag", "t"]


@pytest.mark.parametrize("outcome, per_seed, costs, infra", [
    ("success", {"1": True, "2": True}, {"1": 7.5, "2": 7.5}, []),
    ("failure", {"1": False, "2": False}, {"1": 30.0, "2": 30.0}, []),
    ("infra", {}, {}, [1, 2]),
    ("kernel_fault", {"1": False, "2": False}, {"1": None, "2": None}, []),
])
def test_subprocess_seeds_and_their_outcomes(stub, monkeypatch, outcome, per_seed, costs,
                                             infra):
    """Success and cost come from the output (the cost line need not be the
    last); a seed that died of a machine marker leaves the denominator; one
    whose output holds a kernel fault is a failed seed even beside a machine
    marker."""
    monkeypatch.setenv("STUB_OUTCOME", outcome)
    assert repeat.main(ARGV + ["--num-seeds", "2", "--jobs", "1",
                               "--extra-flag=--kernel=se", "--extra-flag=--no-sod"]) == 0
    s = _summary()
    assert (s["per_seed"], s["per_seed_cost"], s["infra_error_seeds"]) == (per_seed, costs, infra)
    assert s["extra_flags"] == ["--kernel=se", "--no-sod"] and s["complete"]
    log = open(os.path.join("results_tmp", "torch", "cartpole_t_2", "stdout.log")).read()
    assert "flags ['--kernel', 'se', '--no-sod']" in log and "==== stderr ====" in log


@pytest.mark.parametrize("text, infra", [
    ("RuntimeError: No CUDA GPUs are available", True),
    ("CUDA driver initialization failed, you might not have a CUDA gpu.", True),
    ("CUDA error: CUDA-capable device(s) is/are busy or unavailable", True),
    ("CUDA error: uncorrectable ECC error encountered", True),
    ("CUDA error: an illegal memory access was encountered", False),
    ("CUDA error: misaligned address", False),
    ("CUDA error: device-side assert triggered", False),
    ("RuntimeError: nvcc failed (1):", False),
    ("CUDA error: misaligned address\nCUDA error: uncorrectable ECC error encountered", False),
    ("ValueError: NaN in posterior", False),
])
def test_infra_markers_are_the_machines_faults_only(text, infra):
    assert repeat._classify_infra(text, success=False, rc=1) is infra
    # a seed that finished, or exited 0, is an outcome whatever it logged
    assert not repeat._classify_infra(text, success=True, rc=0)
    assert not repeat._classify_infra(text, success=False, rc=0)


def test_jobs_run_seeds_at_once_and_keep_each_log(stub):
    assert repeat.main(ARGV + ["--num-seeds", "3", "--jobs", "2"]) == 0
    assert _summary()["per_seed"] == {"1": True, "2": True, "3": True}
    for s in (1, 2, 3):
        log = open(os.path.join("results_tmp", "torch", f"cartpole_t_{s}", "stdout.log")).read()
        assert f"[stub] seed {s} " in log and "cumulative cost: 7.5000" in log


@pytest.mark.parametrize("jobs", ["1", "2"])
def test_stop_file_exits_86_at_a_boundary_and_resume_finishes(stub, monkeypatch, jobs):
    """Seed 1 leaves the STOP file: the sweep exits 86 before it starts
    another seed, with seed 1 in its summary (with 2 jobs, seed 2 was
    already running); ``--resume`` runs the rest."""
    stop = os.path.join("results_tmp", "torch", "repeat_cartpole_t.STOP")
    monkeypatch.setenv("STUB_STOP", stop)
    argv = ARGV + ["--num-seeds", "4", "--jobs", jobs]
    assert repeat.main(argv) == repeat.STOP_EXIT_CODE
    partial = _summary()
    assert not partial["complete"] and not os.path.exists(stop)
    assert "1" in partial["per_seed"] and len(partial["per_seed"]) == int(jobs)
    monkeypatch.delenv("STUB_STOP")
    assert repeat.main(argv + ["--resume"]) == 0
    s = _summary()
    assert s["complete"] and s["per_seed"] == {str(k): True for k in range(1, 5)}
    # the resumed seeds continue from their checkpoints
    assert "resume True" in open(os.path.join("results_tmp", "torch", "cartpole_t_4",
                                              "stdout.log")).read()


def test_in_process_runs_the_scripts_run_and_takes_scenario_kw(tmp_path, monkeypatch):
    """``--in-process`` (the default of a sequential run): each seed's config
    from its script's flags with ``--scenario-kw`` on top, through ``run``,
    its output in its ``stdout.log``."""
    from mcpilco_tpu_torch.scripts import train_cartpole

    monkeypatch.chdir(tmp_path)
    seen = []

    class Agent:
        trials = []

        def trial_cumulative_cost(self):
            return 8.25

    def fake_run(cfg, device, auto_resume=False):
        seen.append((cfg.seed, cfg.kernel, cfg.gp_epochs, cfg.num_trials, device, auto_resume))
        print("training", cfg.seed)
        return Agent(), 0

    monkeypatch.setattr(train_cartpole, "run", fake_run)
    scen, script, _ = repeat.SCENARIOS["cartpole"]
    monkeypatch.setitem(repeat.SCENARIOS, "cartpole", (scen, script, lambda a: True))
    assert repeat.main(ARGV + ["--num-seeds", "2", "--in-process", "--trials", "2",
                               "--extra-flag=--kernel=se", "--scenario-kw", "gp_epochs=7"]) == 0
    assert seen == [(1, "se", 7, 2, "cpu", False), (2, "se", 7, 2, "cpu", False)]
    assert _summary()["per_seed_cost"] == {"1": 8.25, "2": 8.25}
    log = open(os.path.join("results_tmp", "torch", "cartpole_t_2", "stdout.log")).read()
    assert log == "training 2\n"


def test_in_process_watchdog_exits_87_and_saves_the_log(stub):
    """A seed that goes silent (a call hung on the card) ends the process
    with 87 after ``--stall-secs``, its output so far saved."""
    code = ("import stub_train\n"
            "from mcpilco_tpu_torch.scripts import repeat\n"
            "scen, _, ok = repeat.SCENARIOS['cartpole']\n"
            "repeat.SCENARIOS['cartpole'] = (scen, stub_train, ok)\n"
            f"raise SystemExit(repeat.main({ARGV + ['--num-seeds', '1', '--stall-secs', '2']}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=repeat._child_env())
    assert r.returncode == repeat.WATCHDOG_EXIT_CODE, r.stderr[-800:]
    assert "WATCHDOG: seed 1 wrote no output" in r.stderr and "Thread" in r.stderr
    log = open(os.path.join("results_tmp", "torch", "cartpole_t_1", "stdout.log")).read()
    assert "[stub] training seed 1" in log and "WATCHDOG" in log


@pytest.mark.parametrize("outcome", ["ticking", "fitting"])
def test_in_process_watchdog_lets_a_silent_optimization_run(stub, outcome):
    """A seed that prints nothing for longer than ``--stall-secs`` while its
    optimizer iterates, or its model fit runs epochs, is healthy: the sweep
    ends with 0, and the seed's output reached the console as well as its
    log."""
    code = ("import stub_train\n"
            "from mcpilco_tpu_torch.scripts import repeat\n"
            "scen, _, _ = repeat.SCENARIOS['cartpole']\n"
            "repeat.SCENARIOS['cartpole'] = (scen, stub_train, lambda agent: True)\n"
            f"raise SystemExit(repeat.main({ARGV + ['--num-seeds', '1', '--stall-secs', '2']}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=dict(repeat._child_env(), STUB_OUTCOME=outcome))
    assert r.returncode == 0, r.stderr[-800:]
    assert "WATCHDOG" not in r.stderr and "[stub] training seed 1" in r.stdout
    assert _summary()["per_seed_cost"] == {"1": 7.25}
    log = open(os.path.join("results_tmp", "torch", "cartpole_t_1", "stdout.log")).read()
    assert log == "[stub] training seed 1\n"


@pytest.mark.parametrize("ticks", [1, 0])
def test_farm_watchdog_exits_87_after_the_heartbeat_stops(tmp_path, ticks):
    """No return to the host for ``stall_secs`` after the first: exit 87
    with the batch's log saved; before the first the longer grace holds."""
    code = textwrap.dedent(f"""
        import io, time
        from mcpilco_tpu_torch.scripts import repeat
        buf = io.StringIO("[seed-farm] trial 0")
        state = dict(t=time.time(), ticks={ticks}, batch=[5, 6], buf=buf,
                     log_dirs=["a_5", "a_6"])
        repeat._start_farm_watchdog(1, state)
        time.sleep(6)
        print("alive")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=tmp_path, env=repeat._child_env())
    if ticks:
        assert r.returncode == repeat.WATCHDOG_EXIT_CODE and "FARM WATCHDOG" in r.stderr
        for d in ("a_5", "a_6"):
            assert "[seed-farm] trial 0" in (tmp_path / d / "stdout.log").read_text()
    else:
        assert r.returncode == 0 and "alive" in r.stdout, r.stderr[-500:]


@pytest.mark.parametrize("rc, launches, want", [(None, 2, 0), (2, 1, 2)],
                         ids=["stall_then_done", "immediate_rc2"])
def test_supervise_relaunches_after_a_stall_only(tmp_path, monkeypatch, rc, launches, want):
    (tmp_path / "stub_sweep.py").write_text(STUB_SWEEP)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(repeat, "SWEEP_CMD", [sys.executable, str(tmp_path / "stub_sweep.py")])
    if rc is not None:
        monkeypatch.setenv("STUB_RC", str(rc))
    assert repeat.main(["--num-seeds", "2", "--supervise", "1", "--device", "cpu"]) == want
    got = (tmp_path / "launches.txt").read_text().splitlines()
    assert len(got) == launches
    assert got[0] == "--num-seeds 2 --device cpu"
    if launches == 2:
        assert got[1] == "--num-seeds 2 --device cpu --resume"


@pytest.mark.parametrize("argv, match", [
    (["--extra-flag=--kernel=se"], "--extra-flag needs --no-farm"),
    (["--no-farm", "--jobs", "2", "--scenario-kw", "gp_epochs=3"], "--scenario-kw is for"),
    (["--jobs", "2", "--in-process"], "--jobs N"),
], ids=["extra_flag_farm", "scenario_kw_subprocess", "jobs_in_process"])
def test_refused_combinations(tmp_path, monkeypatch, argv, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        repeat.main(["--num-seeds", "1", "--device", "cpu"] + argv)


# ------------------------------------------------------------ summarize_results


def _jax_summarize():
    spec = importlib.util.spec_from_file_location(
        "jax_summarize_results", os.path.join(REPO, "scripts", "summarize_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SUMMARIES = {
    "repeat_cartpole_a.json": {"scenario": "cartpole", "per_seed": {"1": True, "2": False},
                               "per_seed_cost": {"1": 7.6, "2": 31.2}},
    "repeat_cartpole_b.json": {"scenario": "cartpole", "per_seed": {"2": True, "3": True},
                               "per_seed_cost": {"2": 7.7, "3": 7.55}},
    "repeat_cartpole_pms_legacyvar.json": {"scenario": "cartpole_pms", "per_seed": {"1": True},
                                           "per_seed_cost": {"1": 11.0}},
    "repeat_mj_cap2.json": {"scenario": "mj", "per_seed": {"4": False},
                            "per_seed_cost": {"4": None}},
    "repeat_furuta_kw.json": {"scenario": "furuta", "extra_flags": ["--smoke", "--no-sem"],
                              "scenario_kw": ["gp_epochs=5"],
                              "per_seed": {"1": True, "2": None},
                              "per_seed_cost": {"1": 3.0, "2": 4.0}},
    "repeat_notes.json": {"scenario": "x"},
}


def test_summarize_rows_equal_the_jax_scripts(tmp_path, monkeypatch):
    """The port's merge (later file wins), arm labels (filename markers
    included), quartiles and rows against the JAX script's on the same
    files; the port names the package in a column."""
    from mcpilco_tpu_torch.scripts import summarize_results as port

    jax_sr = _jax_summarize()
    res = tmp_path / "results"
    res.mkdir()
    for i, (name, rec) in enumerate(SUMMARIES.items()):
        (res / name).write_text(json.dumps(rec))
        os.utime(res / name, (1e9 + i, 1e9 + i))
    files = [str(p) for p in res.glob("repeat_*.json")]
    for name, rec in SUMMARIES.items():
        path = str(res / name)
        assert port.arm_label(path, rec) == jax_sr.arm_label(path, rec)
    assert port.merge(files, root=REPO) == jax_sr.merge(files)
    for costs in ([], [7.5], [7.6, 31.2, 7.55, 7.7], list(range(11))):
        assert port.quartiles(costs) == jax_sr.quartiles(costs)
    monkeypatch.setattr(jax_sr, "REPO", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["summarize_results.py", "--json"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_sr.main()
    jax_rows = json.loads(out.getvalue())
    rows = port.rows(port.merge(files, root=str(tmp_path)), "torch")
    assert [r.pop("package") for r in rows] == ["torch"] * len(jax_rows)
    assert rows == jax_rows


def test_a_cut_down_sweep_leaves_the_flagship_row(stub, monkeypatch):
    """A smoke sweep and a ``--trials`` sweep of seeds that the committed
    flagship summary holds, in ``results_tmp/torch`` where ``repeat`` writes
    them: read by default beside ``results/torch``, each is a row of its own
    and the flagship's row is the committed file's alone."""
    from mcpilco_tpu_torch.scripts import summarize_results as port

    flagship = os.path.join(REPO, "results", "torch", "repeat_cartpole_h100.json")
    argv = ["--scenario", "cartpole", "--no-farm", "--device", "cpu", "--jobs", "1",
            "--num-seeds", "2"]
    monkeypatch.setenv("STUB_OUTCOME", "failure")
    assert repeat.main(argv + ["--smoke"]) == 0
    assert repeat.main(argv + ["--trials", "1", "--out-tag", "t"]) == 0
    with open(os.path.join("results_tmp", "torch", "repeat_cartpole.json")) as f:
        assert (json.load(f)["smoke"], _summary()["trials"]) == (True, 1)

    def table(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert port.main(["--json", "--jax-dir", str(stub / "none")] + list(argv)) == 0
        return {r["scenario"]: r for r in json.loads(out.getvalue())}

    alone, merged = table("--dir", flagship), table()
    assert sorted(merged) == ["cartpole", "cartpole [--smoke]", "cartpole [--trials=1]"]
    assert merged["cartpole"] == alone["cartpole"]
    assert merged["cartpole [--smoke]"]["successes"] == 0


@pytest.mark.parametrize("name", ["train_cartpole", "train_cartpole_pms", "train_furuta",
                                  "train_cartpole_mujoco", "train_ur5"])
def test_depth_cut_flags_leave_the_width(name):
    """``--trials``, ``--opt-steps`` and ``--gp-epochs`` cut a train script's
    config in depth and change no other field."""
    import dataclasses

    script = importlib.import_module(f"mcpilco_tpu_torch.scripts.{name}")
    full, _ = script.parse([])
    cut, _ = script.parse(["--trials", "1", "--opt-steps", "5", "--gp-epochs", "300"])
    assert (cut.num_trials, cut.opt_steps, cut.gp_epochs) == (1, (5,), 300)
    assert dataclasses.replace(cut, num_trials=full.num_trials, opt_steps=full.opt_steps,
                               gp_epochs=full.gp_epochs) == full


def test_summarize_prints_both_packages_side_by_side(tmp_path, monkeypatch, capsys):
    from mcpilco_tpu_torch.scripts import summarize_results as port

    mine, jax_dir = tmp_path / "torch", tmp_path / "jax"
    mine.mkdir()
    jax_dir.mkdir()
    (mine / "repeat_cartpole_h100.json").write_text(json.dumps(SUMMARIES["repeat_cartpole_b.json"]))
    (jax_dir / "repeat_cartpole_x.json").write_text(json.dumps(SUMMARIES["repeat_cartpole_a.json"]))
    assert port.main(["--dir", str(mine), "--jax-dir", str(jax_dir), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [(r["scenario"], r["package"], r["successes"], r["seeds"]) for r in rows] == [
        ("cartpole", "jax", 1, 2), ("cartpole", "torch", 2, 2)]
    assert port.main(["--dir", str(mine), "--jax-dir", str(jax_dir)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].startswith("| Scenario | Package |") and len(table) == 4
    assert "| cartpole | torch | 2 | 2/2 (100%) |" in table[3]


# ------------------------------------------------------------ the timing scripts


def test_profile_farm_smoke(tmp_path):
    from mcpilco_tpu_torch.scripts import profile_farm

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_farm.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "p.json")])
    assert rc == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last) == ["1", "2"] and last == json.loads((tmp_path / "p.json").read_text())
    for S, row in last.items():
        assert set(row) == {"ms_per_seed_step", "ms_per_batched_step", "capture_s", "steps",
                            "reads", "M"}
        # chunk_steps_override=40 holds the 4 steps in one read
        assert row["steps"] == 4 and row["reads"] == 1 and row["ms_per_seed_step"] > 0
        assert row["ms_per_batched_step"] == pytest.approx(int(S) * row["ms_per_seed_step"])


def test_bench_particle_scaling_quick(tmp_path):
    from mcpilco_tpu_torch.scripts import bench_particle_scaling

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_particle_scaling.main(["24,48", "--quick", "--device", "cpu",
                                          "--out", str(tmp_path / "b.json")])
    assert rc == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last) == ["24", "48"]
    for row in last.values():
        assert {"ms_per_step", "replay_ms_per_step", "us_per_particle_step", "capture_s",
                "steps", "k1_per_step", "k2_per_step", "cost_first_last", "predict_err",
                "fitted_err_vs_f64"} == set(row)
        # the CPU predicts through the plain ops: equal to them, no kernel
        assert row["steps"] == 20 and row["predict_err"] == 0.0 and row["k1_per_step"] == 0
        assert all(map(lambda c: c == c, row["cost_first_last"]))
