"""A seed-farm batch cut at a trial boundary and resumed from its lanes'
``complete_trial<i>`` checkpoints, against the batch that was never cut.

Every comparison is bitwise: on one device a resumed lane reads exactly the
state the uncut lane carried into its next trial (dataset, policy,
``num_collections``; the keys are functions of the seed and the trial), so
nothing may differ.  The scenarios run at their ``--smoke`` width with the
depth cut (3 trials of 3 optimizer steps, 40-epoch GP fits).
"""

import dataclasses
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mcpilco_tpu_torch.control.mc_pilco import complete_trials
from mcpilco_tpu_torch.parallel import multiseed
from mcpilco_tpu_torch.parallel.multiseed import FarmStopped, SeedFarm
from mcpilco_tpu_torch.scenarios import cartpole, cartpole_pms, furuta
from mcpilco_tpu_torch.scripts import repeat
from mcpilco_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

SEEDS = [2, 3]
SCENARIOS = {
    "cartpole": (cartpole, cartpole.CartpoleConfig),
    "cartpole_pms": (cartpole_pms, cartpole_pms.CartpolePMSConfig),
    "furuta": (furuta, furuta.FurutaConfig),
}


def _cfg(name):
    mod, cls = SCENARIOS[name]
    return dataclasses.replace(cls(seed=SEEDS[0]).smoke(), num_trials=3, opt_steps=(3,),
                               gp_epochs=40)


def _farm(name, root, seeds=SEEDS, cfg=None):
    mod = SCENARIOS[name][0]
    cfg = cfg or _cfg(name)
    agent, kwargs = mod.build(cfg, "cpu")
    farm = SeedFarm(agent, seeds,
                    policy_init_fn=lambda k: mod.policy_init(cfg, agent.policy, k, "cpu"))
    kwargs = dict(kwargs, verbose=False,
                  log_dirs=[os.path.join(root, f"{name}_{s}") for s in seeds])
    return farm, kwargs


def _stop_after(k):
    """A ``stop`` that asks to stop at the boundary after trial ``k``."""
    calls = itertools.count()
    return lambda: next(calls) == k


def _assert_same_result(a, b):
    """Two farm results (and their farms) bitwise equal in every number."""
    (ra, fa), (rb, fb) = a, b
    assert len(ra.trial_logs) == len(rb.trial_logs)
    for la, lb in zip(ra.trial_logs, rb.trial_logs):
        for f in multiseed._LANE_FIELDS:
            va, vb = getattr(la, f), getattr(lb, f)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f
    assert sorted(ra.policy_params) == sorted(rb.policy_params)
    for k in ra.policy_params:
        assert torch.equal(ra.policy_params[k], rb.policy_params[k]), k
    assert np.array_equal(fa.gp_x, fb.gp_x) and np.array_equal(fa.gp_y, fb.gp_y)
    assert fa.num_collections == fb.num_collections == len(fa.trials) == len(fb.trials)
    for ta, tb in zip(fa.trials, fb.trials):
        for va, vb in zip(ta, tb):
            assert va.dtype == vb.dtype and np.array_equal(va, vb)


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def uncut(request, tmp_path_factory):
    name = request.param
    root = str(tmp_path_factory.mktemp(f"uncut_{name}"))
    farm, kwargs = _farm(name, root)
    return name, root, (farm.run(**kwargs), farm)


@pytest.mark.parametrize("k", [0, 1])
def test_cut_and_resumed_batch_is_bitwise_the_uncut_one(uncut, k, tmp_path):
    name, _, want = uncut
    root = str(tmp_path)
    farm, kwargs = _farm(name, root)
    with pytest.raises(FarmStopped) as stopped:
        farm.run(**kwargs, stop=_stop_after(k))
    assert stopped.value.trial == k
    for s in SEEDS:  # only the newest complete trial is kept
        assert sorted(complete_trials(os.path.join(root, f"{name}_{s}"))) == [k]
    fresh, kwargs = _farm(name, root)
    got = fresh.run(**kwargs, resume=True)
    assert fresh.resumed_trial == k
    _assert_same_result((got, fresh), want)
    for s in SEEDS:
        assert sorted(complete_trials(os.path.join(root, f"{name}_{s}"))) == [2]
    # the resumed lanes' last checkpoints hold the uncut ones' trees: the
    # trials' and the last optimizer rollout's particles among them
    for s in SEEDS:
        paths = [complete_trials(os.path.join(r, f"{name}_{s}"))[2] for r in (uncut[1], root)]
        got, want = (ckpt.peek_meta(p) for p in paths)
        for key in ("trial_measured", "trial_inputs", "trial_true", "trial_noisy"):
            assert got[key] == want[key], key
        for tree in ("trial_log_2", "gp_x", "gp_y", "policy_params"):
            with np.load(os.path.join(paths[0], f"{tree}.npz")) as a, \
                    np.load(os.path.join(paths[1], f"{tree}.npz")) as b:
                assert sorted(a.files) == sorted(b.files)
                for leaf in a.files:
                    assert np.array_equal(a[leaf], b[leaf]), (tree, leaf)


def test_resume_without_checkpoints_starts_afresh(tmp_path):
    farm, kwargs = _farm("cartpole", str(tmp_path))
    kwargs["num_trials"] = 1
    res = farm.run(**kwargs, resume=True)
    assert farm.resumed_trial is None and len(res.trial_logs) == 1


def test_lane_checkpoint_restores_through_mcpilco(uncut):
    """A lane's ``complete_trial2`` loads into the seed's own sequential
    agent through ``load_checkpoint``: its dataset, GP, policy, trials
    and trial logs, the last one with the optimizer's last particle
    rollout."""
    name, root, (res, farm) = uncut
    mod = SCENARIOS[name][0]
    for i, s in enumerate(SEEDS):
        log_dir = os.path.join(root, f"{name}_{s}")
        agent, _ = mod.build(dataclasses.replace(_cfg(name), seed=s, log_dir=log_dir), "cpu")
        agent.load_checkpoint(complete_trials(log_dir)[2])
        assert len(agent.trial_logs) == 3 and len(agent.trials) == farm.num_collections == 4
        for got, want in zip(agent.trials, farm.trials):
            for f in got._fields:
                assert np.array_equal(getattr(got, f), getattr(want, f)[i]), f
        opt = agent.optimizer
        states = agent.trial_logs[-1].particles_states
        assert states.shape == (opt.horizon, opt.num_particles, agent.model.state_dim)
        assert np.array_equal(states, farm.opt_info["states"][i].numpy())
        assert agent.trial_logs[0].particles_states.size == 0
        assert np.array_equal(agent.gp_x, farm.gp_x[i])
        assert np.array_equal(agent.gp_y, farm.gp_y[i])
        assert agent.num_collections == farm.num_collections
        for k, v in agent.policy_params.items():
            assert torch.equal(v, res.policy_params[k][i]), k
        for got, want in zip(agent.gp_params.log_sigma_n, farm.gp_params.log_sigma_n[i]):
            assert torch.equal(got, want)
        for t, log in enumerate(agent.trial_logs):
            steps = int(res.trial_logs[t].steps_done[i])
            assert log.steps_done == steps
            assert np.array_equal(log.cost_history, res.trial_logs[t].cost_history[i, :steps])
        assert agent.posterior is not None


def test_auto_resume_refuses_a_lane_checkpoint(uncut):
    """A lane keeps no raw trials, which a sequential trial reads: the
    seed's own agent refuses to continue it and names the batch, also where
    the seed's own older checkpoints lie beside it."""
    name, root, _ = uncut
    log_dir = os.path.join(root, f"{name}_{SEEDS[0]}")
    mod = SCENARIOS[name][0]
    agent, _ = mod.build(dataclasses.replace(_cfg(name), seed=SEEDS[0], log_dir=log_dir), "cpu")
    agent.save_checkpoint("complete_trial0")  # an older one of the seed's own
    try:
        with pytest.raises(RuntimeError,
                           match=r"by the farm batch \[2, 3\], not by a seed trained alone"):
            agent.auto_resume()
    finally:
        shutil.rmtree(os.path.join(log_dir, "complete_trial0"))
    assert agent.trial_logs == [] and agent.num_collections == 0


def test_a_lane_set_of_another_batch_is_refused(uncut, tmp_path):
    name, root, _ = uncut
    other = [SEEDS[0], 7]  # seed 2's lane was written by the batch [2, 3]
    farm, kwargs = _farm(name, root, seeds=other)
    with pytest.raises(RuntimeError,
                       match=r"farm batch \[2, 3\], not by the farm batch \[2, 7\]"):
        farm.run(**kwargs, resume=True)
    cfg = dataclasses.replace(_cfg(name), gp_epochs=41)
    farm, kwargs = _farm(name, root, cfg=cfg)
    with pytest.raises(RuntimeError, match="gp_epochs: checkpoint=40 current=41"):
        farm.run(**kwargs, resume=True)


def test_a_sequential_seeds_checkpoint_is_refused(tmp_path):
    cfg = dataclasses.replace(_cfg("cartpole"), seed=SEEDS[0], num_trials=1,
                              log_dir=str(tmp_path / f"cartpole_{SEEDS[0]}"))
    agent, kwargs = cartpole.build(cfg, "cpu")
    agent.reinforce(**kwargs, verbose=False)
    farm, kwargs = _farm("cartpole", str(tmp_path))
    with pytest.raises(RuntimeError, match="by a seed trained alone"):
        farm.run(**kwargs, resume=True)


REPEAT_ARGV = ["--scenario", "cartpole", "--smoke", "--device", "cpu", "--num-seeds", "2",
               "--farm-batch", "2", "--scenario-kw", "num_trials=2", "--scenario-kw",
               "opt_steps=(5,)", "--scenario-kw", "gp_epochs=40"]


def _stop_farm_after_trial0(monkeypatch, tag):
    """``repeat --farm --out-tag tag`` stopped by its STOP file at the
    boundary after trial 0; exits 86 with the lanes' checkpoints written."""
    stop_file = os.path.join(repeat.OUT_DIR, f"repeat_cartpole_{tag}.STOP")
    save = SeedFarm.save_lanes

    def save_then_stop(self, trial, *a):
        save(self, trial, *a)
        if trial == 0:
            open(stop_file, "w").close()

    with monkeypatch.context() as m:
        m.setattr(SeedFarm, "save_lanes", save_then_stop)
        assert repeat.main(REPEAT_ARGV + ["--out-tag", tag]) == repeat.STOP_EXIT_CODE
    assert not os.path.exists(stop_file)


def test_repeat_resumes_a_stopped_batch_to_the_uncut_summary(tmp_path, monkeypatch, capsys):
    """``repeat --farm``: the STOP file at the boundary after trial 0 exits
    86 with the lanes' checkpoints written; ``--resume`` goes on after trial
    0, says so, and writes the uncut sweep's summary."""
    monkeypatch.chdir(tmp_path)
    argv = REPEAT_ARGV
    assert repeat.main(argv + ["--out-tag", "uncut"]) == 0
    _stop_farm_after_trial0(monkeypatch, "cut")
    assert not os.path.exists(os.path.join(repeat.OUT_DIR, "repeat_cartpole_cut.json"))
    capsys.readouterr()
    assert repeat.main(argv + ["--out-tag", "cut", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[seed-farm] resumed from complete_trial0 of 2 lanes: trial 1 next" in out
    assert "(resumed after trial 0)" in out
    summaries = []
    for tag in ("uncut", "cut"):
        with open(os.path.join(repeat.OUT_DIR, f"repeat_cartpole_{tag}.json")) as f:
            summaries.append({k: v for k, v in json.load(f).items() if k != "tag"})
    assert summaries[0] == summaries[1] and summaries[0]["complete"]
    with open(os.path.join(repeat.OUT_DIR, "cartpole_cut_1", "stdout.log")) as f:
        log = f.read()
    # the cut call's output, then the resumed call's
    assert log.index("STOP file") < log.index("==== resumed after trial 0 ====")


def test_repeat_no_farm_resume_refuses_a_stopped_farm_batch(tmp_path, monkeypatch):
    """A farm batch stopped after trial 0, then resumed as sequential seeds:
    ``repeat`` exits before any seed starts, naming the batch, and records no
    seed as a failure."""
    monkeypatch.chdir(tmp_path)
    _stop_farm_after_trial0(monkeypatch, "lanes")
    summary = os.path.join(repeat.OUT_DIR, "repeat_cartpole_lanes.json")
    for runner in (["--in-process"], ["--jobs", "1"]):
        with pytest.raises(SystemExit, match=r"written by the farm batch \[1, 2\], not by a "
                                             r"seed trained alone"):
            repeat.main(REPEAT_ARGV[:-6] + ["--no-farm", "--out-tag", "lanes", "--resume",
                                            "--trials", "2"] + runner)
        assert not os.path.exists(summary)
    for s in (1, 2):
        assert sorted(complete_trials(repeat.seed_log_dir("cartpole", s, "lanes"))) == [0]
