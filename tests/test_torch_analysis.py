"""The port's analysis tools against the JAX package's scripts on the same
checkpoints: ``analyze_mujoco_failures`` (4PMS and Furuta),
``analyze_pms_bias`` and ``plot_logs``.

The checkpoints are made by the port on the CPU at the configs' smoke width
(40 basis functions, 50 particles, 1 trial), cut in depth to 5 optimizer
steps and a 60-epoch fit; the port's checkpoints load in the JAX package
(``tests/test_torch_checkpoint.py``).  Both packages restore them into the
scenario's default config, as the scripts do.

Tolerances: ``executed_success`` and ``mode`` are equal; ``executed_cost``,
``in_model_cost``, ``in_model_upright_frac``, ``onestep_rmse`` and
``mean_abs_delta`` agree within 1e-4 relative (the JAX rows are taken
unrounded: the script runs with ``round`` as the identity), as do the bias
numbers, which are held against the JAX package's own computation of the
JAX script's lines; the biases and the top quartile's signed error are means
of residuals that nearly cancel, so they are held within 1e-4 of the
residuals' RMSE.  The JAX bias script prints 4 decimals (3 for the
ratios) and returns nothing, so its printed numbers are held within half a
unit of the last printed digit.
"""

import dataclasses
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from mcpilco_tpu_torch.control.mc_pilco import MCPilco
from mcpilco_tpu_torch.scripts import analyze_mujoco_failures as amf
from mcpilco_tpu_torch.scripts import analyze_pms_bias as apb
from mcpilco_tpu_torch.scripts import plot_logs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
# the bias numbers that are means of signed residuals, and the RMSE of
# those residuals
SIGNED = {"bias_filtered": "rmse_filtered", "bias_true": "rmse_true",
          "top_quartile_signed_err": "rmse_true"}
ROW_KEYS = ["executed_cost", "in_model_cost", "in_model_upright_frac", "onestep_rmse",
            "mean_abs_delta"]


def _small(cfg, log_dir):
    return dataclasses.replace(cfg.smoke(), opt_steps=(5,), gp_epochs=60, log_dir=str(log_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One trained seed of 4PMS and of Furuta under a sweep's layout
    (``<root>/<scenario>_<seed>/complete_trial0``), and each run's own
    final-trial cost."""
    from mcpilco_tpu_torch.scenarios import cartpole_pms, furuta

    root = tmp_path_factory.mktemp("sweep")
    costs = {}
    for mod, cfg, prefix in ((cartpole_pms, cartpole_pms.CartpolePMSConfig(seed=1),
                              "cartpole_pms"),
                             (furuta, furuta.FurutaConfig(seed=2), "furuta")):
        agent, kwargs = mod.build(_small(cfg, root / f"{prefix}_{cfg.seed}"), "cpu")
        agent.reinforce(**kwargs)
        costs[prefix] = agent.trial_cumulative_cost(-1)
    return root, costs


def _jax_script(name, argv, monkeypatch, **init_globals):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name), init_globals=init_globals,
                       run_name="__main__")
    except SystemExit as e:  # plot_logs exits with main()'s 0
        assert e.code in (0, None)


def _close(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("scenario,prefix", [("pms", "cartpole_pms"), ("furuta", "furuta")])
def test_failure_rows_match_the_jax_script(runs, scenario, prefix, tmp_path, monkeypatch):
    root, costs = runs
    rows = amf.main(["--scenario", scenario, "--root", str(root), "--device", "cpu"])
    out = tmp_path / "jax_rows.json"
    _jax_script("analyze_mujoco_failures.py", ["--scenario", scenario, "--root", str(root),
                                               "--platform", "cpu", "--json", str(out)],
                monkeypatch, round=lambda v, n=None: v)
    jrows = json.loads(out.read_text())
    assert [r["seed"] for r in rows] == [r["seed"] for r in jrows] == [1 if scenario == "pms"
                                                                      else 2]
    for ours, theirs in zip(rows, jrows):
        # the port's one column more: the delta cap's binding share, on
        # Furuta's capped rollout only
        assert sorted(ours) == sorted(list(theirs) + ["delta_cap_share"])
        assert (ours["delta_cap_share"] is None) == (scenario == "pms")
        if scenario == "furuta":
            assert 0.0 <= ours["delta_cap_share"] <= 1.0
        assert ours["scenario"] == theirs["scenario"] == scenario
        assert ours["executed_success"] == theirs["executed_success"]
        assert ours["mode"] == theirs["mode"]
        for key in ROW_KEYS:
            _close(ours[key], theirs[key])
    # the row's cost is the run's own, to the bit of the CPU's float32 sum
    assert rows[0]["executed_cost"] == pytest.approx(costs[prefix], rel=1e-6)


def test_failure_rows_without_particle_snapshots(runs, tmp_path, monkeypatch):
    """A checkpoint without the optimizer's particle snapshots: the final
    policy's in-model rollout is rebuilt from a generator seeded 0, the same
    on every call, with the optimizer's particles and horizon."""
    from mcpilco_tpu_torch.scenarios import cartpole_pms

    root, _ = runs
    agent, _ = cartpole_pms.build(cartpole_pms.CartpolePMSConfig(seed=1), "cpu")
    agent.load_checkpoint(str(root / "cartpole_pms_1" / "complete_trial0"))
    a, b = amf.in_model_states(agent), amf.in_model_states(agent)
    opt = agent.optimizer
    assert a.shape == (opt.horizon, opt.num_particles, 4) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)

    calls = []
    monkeypatch.setattr(amf, "in_model_states", lambda ag: calls.append(1) or a)
    real_load = MCPilco.load_checkpoint

    def load_without_snapshots(self, path):
        real_load(self, path)
        for lg in self.trial_logs:
            lg.particles_states = np.zeros(0)

    monkeypatch.setattr(MCPilco, "load_checkpoint", load_without_snapshots)
    row = amf.main(["--scenario", "pms", "--root", str(root), "--device", "cpu"])[0]
    assert calls == [1]
    assert row["in_model_upright_frac"] == amf.cartpole_upright_fraction(a)
    assert row["mode"] == amf.mode_of(row["executed_success"], row["in_model_upright_frac"])


def test_furuta_row_from_a_lane_is_the_sequential_seeds(tmp_path):
    """``analyze_mujoco_failures --scenario furuta`` on a farm lane's
    checkpoint (a batch of one seed, which keeps the lane's trials and the
    last optimizer rollout's particles) gives the row that the same seed
    trained alone through ``MCPilco.reinforce`` gives, number for number,
    the cap's binding share included."""
    from mcpilco_tpu_torch.parallel.multiseed import SeedFarm
    from mcpilco_tpu_torch.scenarios import furuta

    cfg = _small(furuta.FurutaConfig(seed=2), tmp_path / "furuta_seq_2")
    agent, kwargs = furuta.build(cfg, "cpu")
    agent.reinforce(**kwargs, verbose=False)
    cfg0 = dataclasses.replace(cfg, seed=0, log_dir=None)
    farm_agent, kw = furuta.build(cfg0, "cpu")
    farm = SeedFarm(farm_agent, [2], policy_init_fn=lambda k: furuta.policy_init(
        cfg0, farm_agent.policy, k, "cpu"))
    farm.run(**kw, verbose=False, log_dirs=[str(tmp_path / "furuta_lane_2")])
    rows = {tag: amf.main(["--scenario", "furuta", "--root", str(tmp_path), "--tag", tag,
                           "--device", "cpu"]) for tag in ("seq", "lane")}
    assert rows["lane"] == rows["seq"] and len(rows["seq"]) == 1
    assert rows["seq"][0]["delta_cap_share"] is not None


@pytest.mark.parametrize("executed_ok,frac,mode", [
    (True, 0.0, "success"), (False, 0.5, "model-optimism"), (False, 0.9, "model-optimism"),
    (False, 0.0999, "optimization"), (False, 0.1, "mixed"), (False, 0.4999, "mixed"),
    (False, float("nan"), "mixed"),
])
def test_mode_thresholds(executed_ok, frac, mode):
    assert amf.mode_of(executed_ok, frac) == mode


def test_run_dirs_take_the_sweep_tag(tmp_path):
    for d in ("cartpole_pms_3", "cartpole_pms_12", "cartpole_pms_legacyvar_4", "furuta_5"):
        (tmp_path / d).mkdir()
    assert [s for s, _ in amf.run_dirs(str(tmp_path), "cartpole_pms")] == [3, 12]
    assert amf.run_dirs(str(tmp_path), "cartpole_pms_legacyvar") == [
        (4, str(tmp_path / "cartpole_pms_legacyvar_4"))]


def _jax_bias(ckpt):
    """The numbers of the JAX script's lines, unrounded, from the JAX
    package (the script computes them inside its f-strings)."""
    import jax.numpy as jnp

    from mcpilco_tpu.scenarios import cartpole_pms as jscen

    agent, _ = jscen.build(jscen.CartpolePMSConfig(seed=1))
    agent.load_checkpoint(ckpt)
    final = agent.trials[-1]

    def residuals(states):
        x, y = agent.model.training_pairs(jnp.asarray(states), jnp.asarray(final.inputs))
        mean, _ = agent.gp.predict(agent.gp_params, agent.posterior, x)
        return np.asarray(mean), np.asarray(y)

    mean_meas, y_meas = residuals(final.measured)
    mean_true, y_true = residuals(final.true[: final.inputs.shape[0]])
    out = {}
    for g, name in enumerate(apb.HEADS):
        res_m, res_t = mean_meas[g] - y_meas[g], mean_true[g] - y_true[g]
        big = np.abs(y_true[g]) > np.quantile(np.abs(y_true[g]), 0.75)
        out[name] = dict(
            rmse_filtered=np.sqrt((res_m ** 2).mean()), bias_filtered=res_m.mean(),
            rmse_true=np.sqrt((res_t ** 2).mean()), bias_true=res_t.mean(),
            top_quartile_signed_err=res_t[big].mean(),
            top_quartile_abs_true=np.abs(y_true[g][big]).mean(),
            pred_over_true=np.abs(mean_true[g][big]).sum() / np.abs(y_true[g][big]).sum(),
            filtered_over_true=np.abs(y_meas[g][big]).sum() / np.abs(y_true[g][big]).sum())
    return out


def test_pms_bias_matches_the_jax_script(runs, capsys, monkeypatch):
    root, _ = runs
    ckpt = str(root / "cartpole_pms_1" / "complete_trial0")
    ours = apb.main([ckpt, "--device", "cpu"])
    our_lines = capsys.readouterr().out.splitlines()
    _jax_script("analyze_pms_bias.py", [ckpt, "--platform", "cpu"], monkeypatch)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith(("checkpoint:", "["))]
    assert len(our_lines) == len(jax_lines) == 5
    number = re.compile(r"[-+]?\d+\.\d+")
    for a, b in zip(our_lines, jax_lines):
        assert number.sub("#", a) == number.sub("#", b)  # the same lines
        for x, y in zip(number.findall(a), number.findall(b)):
            # the JAX script prints 4 (ratios: 3) decimals
            assert abs(float(x) - float(y)) <= 0.5 * 10.0 ** -len(y.split(".")[1]) + 1e-12
    theirs = _jax_bias(ckpt)
    assert sorted(ours) == list(sorted(apb.HEADS))
    for name in apb.HEADS:
        assert sorted(ours[name]) == sorted(theirs[name])
        for key, v in ours[name].items():
            if key in SIGNED:
                # a mean of signed residuals that nearly cancel: 1e-4 of
                # the residuals' own scale (their RMSE), not of the mean
                scale = ours[name][SIGNED[key]]
                assert abs(v - theirs[name][key]) <= RTOL * scale, (name, key)
            else:
                _close(v, theirs[name][key])
    assert all(np.isfinite(v) for r in ours.values() for v in r.values())


def _flagship_log(log_dir):
    from mcpilco_tpu_torch.scenarios import cartpole

    cfg = dataclasses.replace(cartpole.CartpoleConfig(seed=3).smoke(), num_particles=16,
                              opt_steps=(3,), gp_epochs=30, num_basis=10, log_dir=str(log_dir))
    agent, kwargs = cartpole.build(cfg, "cpu")
    agent.reinforce(**kwargs)


def _ur5_log(log_dir):
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions, PolicyOptOptions
    from mcpilco_tpu_torch.scenarios import ur5

    agent, _ = ur5.build(dataclasses.replace(ur5.UR5Config(seed=1).smoke(),
                                             log_dir=str(log_dir)), "cpu")
    tr = ur5.recorded_trials()
    agent.add_external_trial(tr["measured"][0][:41], tr["inputs"][0][:41], exploration=True)
    agent.fit_model(ModelFitOptions(num_epochs=5))
    agent.improve_policy(PolicyOptOptions(opt_steps=2, learning_rate=0.01, p_dropout=0.0), 0)
    agent.save_checkpoint("complete_trial0")


@pytest.mark.parametrize("scenario,make,names", [
    ("cartpole", _flagship_log, ["learning_curves.png", "trajectories.png"]),
    ("ur5", _ur5_log, ["learning_curves.png", "tracking_error.png", "q_final_trial.csv"]),
])
def test_plot_logs_writes_the_jax_scripts_files(scenario, make, names, tmp_path, monkeypatch):
    log_dir = tmp_path / "run"
    make(log_dir)
    written = plot_logs.main([str(log_dir), "--scenario", scenario, "--out",
                              str(tmp_path / "ours")])
    assert [os.path.basename(p) for p in written] == names
    for p in written:
        assert os.path.getsize(p) > 0
        if p.endswith(".png"):
            with open(p, "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    _jax_script("plot_logs.py", [str(log_dir), "--scenario", scenario, "--out",
                                 str(tmp_path / "jax")], monkeypatch)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(names)
    if scenario == "ur5":
        # the final trial's joint angles, against the JAX script's CSV
        np.testing.assert_array_equal(np.loadtxt(tmp_path / "ours" / "q_final_trial.csv",
                                                 delimiter=","),
                                      np.loadtxt(tmp_path / "jax" / "q_final_trial.csv",
                                                 delimiter=","))


# ------------------------------------------------------- the outcome rule

def _summary(path, scenario, outcomes, costs, **extra):
    rec = {"scenario": scenario, "per_seed": {str(s): v for s, v in outcomes.items()},
           "per_seed_cost": {str(s): c for s, c in costs.items()}, **extra}
    path.write_text(json.dumps(rec))
    return str(path)


def test_outcome_rule_on_the_committed_flagship_sweep():
    from mcpilco_tpu_torch.scripts import outcome_parity

    (row,) = [r for r in outcome_parity.main(["--json"]) if r["scenario"] == "cartpole"]
    assert row["port"]["seeds"] == row["port"]["successes"] == 16
    assert row["jax"]["seeds"] == row["jax"]["successes"] == 50
    assert row["fisher_p"] == 1.0 and row["match"]
    assert row["jax"]["success_cost"]["median"] == pytest.approx(7.6304, abs=1e-4)


@pytest.mark.parametrize("scenario,p", [
    ("cartpole_pms", 0.00038), ("cartpole", 0.46), ("cartpole_multi_init", 0.25),
    ("furuta", 0.53)])
def test_outcome_rows_carry_the_rank_test_of_the_successes_costs(scenario, p):
    """The Mann-Whitney p of the committed sweeps' successes' costs against
    the JAX records' (two-sided), printed beside Fisher's p as evidence
    only: the 4PMS successes are cheaper on the port (C.3), the flagship's
    and multi-init's are not."""
    from scipy.stats import mannwhitneyu

    from mcpilco_tpu_torch.scripts import outcome_parity

    (row,) = [r for r in outcome_parity.main(["--json"]) if r["scenario"] == scenario]
    assert row["mannwhitney_p"] == pytest.approx(p, rel=0.02)
    assert row["mannwhitney_p"] == mannwhitneyu(row["port"]["success_costs"],
                                                row["jax"]["success_costs"]).pvalue
    assert len(row["port"]["success_costs"]) == row["port"]["successes"]
    # evidence only: the verdict is the rule's
    assert row["match"] == (row["rate_ok"] and row["median_in_jax_iqr"])


def test_an_incomplete_sweep_is_not_decided(tmp_path, capsys):
    """A summary that says ``"complete": false`` (a sweep cut by the chip
    time) gets a row, but no verdict; the committed Furuta sweep, complete
    since its farm batches resumed from their lanes' checkpoints, gets its
    verdict."""
    from mcpilco_tpu_torch.scripts import outcome_parity

    _summary(tmp_path / "repeat_furuta.json", "furuta", {2: True, 3: False}, {2: 36.0, 3: 90.0},
             complete=False)
    (row,) = outcome_parity.main(["--port", str(tmp_path), "--json"])
    assert row["complete"] is False and row["match"] is None
    assert (row["port"]["seeds"], row["jax"]["seeds"]) == (2, 9)
    capsys.readouterr()
    outcome_parity.main(["--port", str(tmp_path)])
    (line,) = [l for l in capsys.readouterr().out.splitlines() if l.startswith("| furuta |")]
    assert line.startswith("| furuta | 1/2 (sweep incomplete) |") and "| not decided |" in line
    (row,) = [r for r in outcome_parity.main(["--json"]) if r["scenario"] == "furuta"]
    assert row["complete"] is True and (row["port"]["successes"], row["port"]["seeds"]) == (6, 18)
    # seeds 2-19: neither the rate (Fisher p 0.046) nor the successes' median
    # matches (C.4)
    assert not row["rate_ok"] and not row["median_in_jax_iqr"] and row["match"] is False


def test_outcome_rows_against_a_jax_analysis_and_over_all_seeds(tmp_path):
    """``--jax-rows``: a Furuta sweep held against the JAX package's failure
    analysis of seeds 1-10 (round 3: 7/10) instead of its records; every row
    also carries the rank test of all seeds' costs (evidence only)."""
    from scipy.stats import fisher_exact, mannwhitneyu

    from mcpilco_tpu_torch.scripts import outcome_parity

    port = _summary(tmp_path / "repeat_furuta.json", "furuta",
                    {2: True, 3: False, 4: False}, {2: 36.0, 3: 60.0, 4: 55.0})
    rows_file = os.path.join(REPO, "results", "analyze_furuta_failures_r3.json")
    (row,) = outcome_parity.main(["--port", port, "--jax-rows", rows_file, "--json"])
    with open(rows_file) as f:
        jax_rows = json.load(f)
    assert (row["jax"]["successes"], row["jax"]["seeds"]) == (7, 10)
    assert row["jax_files"] == [os.path.relpath(rows_file, REPO)]
    assert row["fisher_p"] == pytest.approx(fisher_exact([[1, 2], [7, 3]])[1])
    assert row["mannwhitney_all_p"] == mannwhitneyu(
        [36.0, 60.0, 55.0], [r["executed_cost"] for r in jax_rows]).pvalue
    (row,) = outcome_parity.main(["--port", port, "--json"])  # the records: 7/9
    assert (row["jax"]["successes"], row["jax"]["seeds"]) == (7, 9)
    assert row["mannwhitney_all_p"] == mannwhitneyu(row["port"]["all_costs"],
                                                    row["jax"]["all_costs"]).pvalue


@pytest.mark.parametrize("wins,cost,p_ok,median_ok", [
    (6, 11.36, True, True),     # 6/8 against 35/50, the JAX median
    (6, 11.00, True, False),    # below the JAX successes' q25 (11.094)
    (6, 12.30, True, False),    # above their q75 (12.248)
    (0, 11.36, False, False),   # 0/8: Fisher's p < 0.05, no successes' median
    (8, 12.24, True, True),
])
def test_outcome_rule_on_a_4pms_sweep(tmp_path, wins, cost, p_ok, median_ok):
    from scipy.stats import fisher_exact

    from mcpilco_tpu_torch.scripts import outcome_parity

    seeds = range(1, 9)
    _summary(tmp_path / "repeat_cartpole_pms.json", "cartpole_pms",
             {s: s <= wins for s in seeds}, {s: cost if s <= wins else 40.0 for s in seeds})
    # another arm, and a scenario without a JAX record, stay out of its row
    _summary(tmp_path / "repeat_cartpole_pms_x.json", "cartpole_pms", {9: False}, {9: 50.0},
             extra_flags=["--delta-cap=2.0"])
    _summary(tmp_path / "repeat_ur5.json", "ur5", {1: True}, {1: 1.0})
    (row,) = outcome_parity.main(["--port", str(tmp_path), "--json"])
    assert row["scenario"] == "cartpole_pms" and row["port"]["seeds"] == 8
    assert row["jax"]["successes"] == 35 and row["jax"]["seeds"] == 50
    assert row["fisher_p"] == pytest.approx(fisher_exact([[wins, 8 - wins], [35, 15]])[1])
    assert (row["rate_ok"], row["median_in_jax_iqr"]) == (p_ok, median_ok)
    assert row["match"] == (p_ok and median_ok)
    assert row["port"]["all_cost"]["median"] == (cost if wins > 4 else 40.0
                                                 if wins < 4 else (cost + 40) / 2)
