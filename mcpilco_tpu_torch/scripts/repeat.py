"""The multi-seed outcome protocol: train a range of seeds, report the success
rate and the quartiles of the final trial's cumulative cost.

    python -m mcpilco_tpu_torch.scripts.repeat --scenario cartpole --num-seeds 50
    python -m mcpilco_tpu_torch.scripts.repeat --farm-batch 8            # SeedFarm batches
    python -m mcpilco_tpu_torch.scripts.repeat --scenario ur5            # one after another
    python -m mcpilco_tpu_torch.scripts.repeat --resume                  # skip finished seeds

The seeds train as lanes of ``parallel.multiseed.SeedFarm``,
``--farm-batch`` seeds at a time: by default for the scenarios whose plant
runs on the device (``FARMABLE``), with ``--farm`` also for
``cartpole_mujoco``, whose MuJoCo plant the farm steps seed by seed on the
host.  Otherwise (``--no-farm``, and ``ur5``, which the farm does not
take) they run one after another in this process, each through its train
script's ``run`` in ``results_tmp/torch/<scenario>[_<tag>]_<seed>``.  A UR5
seed succeeds when it tracks within 10 degrees RMS on every joint.  The summary,
``results_tmp/torch/repeat_<scenario>[_<tag>].json``, has the keys of the
JAX package's ``scripts/repeat.py`` summary and is rewritten after every
seed or batch, so ``--resume`` can skip the seeds already done; a resumed
sequential seed continues from its newest completed trial.
"""

import argparse
import ast
import dataclasses
import json
import os
import traceback

import torch

from ..parallel.multiseed import SeedFarm
from ..scenarios import cartpole, cartpole_mujoco, cartpole_pms, furuta, ur5
from . import (train_cartpole, train_cartpole_mujoco, train_cartpole_pms, train_furuta,
               train_ur5)

OUT_DIR = os.path.join("results_tmp", "torch")


def _swung_up(scen):
    return lambda agent: scen.swingup_success(agent.trials[-1].true)


# scenario -> (scenario module, train script, config of one seed, success of a
# trained agent)
SCENARIOS = {
    "cartpole": (cartpole, train_cartpole, lambda s: cartpole.CartpoleConfig(seed=s),
                 _swung_up(cartpole)),
    "cartpole_multi_init": (cartpole, train_cartpole,
                            lambda s: cartpole.CartpoleConfig(seed=s, multi_init=True),
                            _swung_up(cartpole)),
    "cartpole_pms": (cartpole_pms, train_cartpole_pms,
                     lambda s: cartpole_pms.CartpolePMSConfig(seed=s), _swung_up(cartpole_pms)),
    "furuta": (furuta, train_furuta, lambda s: furuta.FurutaConfig(seed=s), _swung_up(furuta)),
    "cartpole_mujoco": (cartpole_mujoco, train_cartpole_mujoco,
                        lambda s: cartpole_mujoco.CartpoleMujocoConfig(seed=s),
                        _swung_up(cartpole_mujoco)),
    "ur5": (ur5, train_ur5, lambda s: ur5.UR5Config(seed=s), ur5.tracking_success),
}
# the farm is the default for the scenarios whose plant runs on the device;
# cartpole_mujoco's host plant farms on request (--farm)
FARMABLE = ("cartpole", "cartpole_multi_init", "cartpole_pms", "furuta")
FARM_SUPPORTED = FARMABLE + ("cartpole_mujoco",)


def _config(args, seed):
    """One seed's config: the scenario's defaults, cut by ``--smoke``,
    ``--trials`` and ``--scenario-kw``, logging to its own directory."""
    cfg = SCENARIOS[args.scenario][2](seed)
    if args.smoke:
        cfg = cfg.smoke()
    kw = {}
    for item in args.scenario_kw:
        k, _, v = item.partition("=")
        try:
            kw[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            kw[k] = v  # bare strings (e.g. vel_est=savgol)
    if args.trials is not None:
        kw["num_trials"] = args.trials
    tag = f"_{args.out_tag}" if args.out_tag else ""
    kw["log_dir"] = os.path.join(OUT_DIR, f"{args.scenario}{tag}_{seed}")
    return dataclasses.replace(cfg, **kw)


def run_sequential(args, seeds, results, costs):
    """Each seed through its train script's ``run``; a seed that raises is
    recorded as a failure without a cost, and the sweep goes on."""
    _, script, _, success = SCENARIOS[args.scenario]
    for s in seeds:
        try:
            agent, _ = script.run(_config(args, s), args.device, auto_resume=args.resume)
            results[s] = success(agent)
            costs[s] = round(agent.trial_cumulative_cost(), 4)
        except Exception:  # one crashed seed must not lose the sweep
            traceback.print_exc()
            results[s], costs[s] = False, None
        print(f"[repeat] seed {s}: success={results[s]} cost={costs[s]}", flush=True)
        write_summary(args, results, costs, complete=False)


def run_farm(args, seeds, results, costs):
    """``--farm-batch`` seeds at a time as lanes of one ``SeedFarm``."""
    scen = SCENARIOS[args.scenario][0]
    for lo in range(0, len(seeds), args.farm_batch):
        batch = seeds[lo: lo + args.farm_batch]
        cfg = _config(args, batch[0])
        agent, kwargs = scen.build(cfg, args.device)
        farm = SeedFarm(agent, batch, policy_init_fn=lambda k: scen.policy_init(
            cfg, agent.policy, k, args.device))
        res = farm.run(**kwargs)
        for i, s in enumerate(batch):
            # a per-trial cost schedule scores the final trial with its own row
            stage = agent.cost.stage_costs(torch.as_tensor(res.final_true[i][:, None, :]),
                                           torch.as_tensor(res.final_inputs[i][:, None, :]),
                                           len(res.trial_logs) - 1)
            results[s] = scen.swingup_success(res.final_true[i])
            costs[s] = round(float(torch.sum(stage)), 4)
            print(f"[repeat] seed {s}: success={results[s]} cost={costs[s]}", flush=True)
        write_summary(args, results, costs, complete=False)


def summary_path(args) -> str:
    tag = f"_{args.out_tag}" if args.out_tag else ""
    return os.path.join(OUT_DIR, f"repeat_{args.scenario}{tag}.json")


def load_resume(args):
    """The finished seeds of an earlier (partial) sweep of this scenario and tag."""
    path = summary_path(args)
    if not os.path.exists(path):
        return {}, {}
    with open(path) as f:
        prev = json.load(f)
    results = {int(k): bool(v) for k, v in prev.get("per_seed", {}).items()}
    costs = {int(k): prev.get("per_seed_cost", {}).get(k) for k in prev.get("per_seed", {})}
    print(f"[repeat] resume: {len(results)} completed seeds loaded from {path}")
    return results, costs


def write_summary(args, results, costs, complete):
    """Write the summary with the keys of the JAX package's: success rate,
    cost quartiles (linear interpolation), per-seed outcomes and costs.
    The port sorts no seed out as an infrastructure failure and passes no
    flags through to a script, so ``infra_error_seeds`` and ``extra_flags``
    stay empty."""
    rate = sum(results.values()) / max(len(results), 1)
    known = sorted(c for c in costs.values() if c is not None)
    quartiles = None
    if known:
        def q(p):
            i = p * (len(known) - 1)
            lo, hi = int(i), min(int(i) + 1, len(known) - 1)
            return round(known[lo] + (i - lo) * (known[hi] - known[lo]), 4)
        quartiles = {"q25": q(0.25), "median": q(0.5), "q75": q(0.75),
                     "min": known[0], "max": known[-1]}
    summary = {"scenario": args.scenario, "seeds": sorted(results), "success_rate": rate,
               "final_trial_cost_quartiles": quartiles,
               "per_seed": {str(k): bool(v) for k, v in sorted(results.items())},
               "per_seed_cost": {str(k): costs[k] for k in sorted(costs)},
               "infra_error_seeds": [], "tag": args.out_tag, "extra_flags": [],
               "scenario_kw": args.scenario_kw, "complete": complete}
    out = summary_path(args)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(out + ".tmp", "w") as f:
        json.dump(summary, f, indent=1)
    os.replace(out + ".tmp", out)
    return summary, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("repeat over seeds")
    p.add_argument("--scenario", default="cartpole", choices=sorted(SCENARIOS))
    p.add_argument("--first-seed", type=int, default=1)
    p.add_argument("--num-seeds", type=int, default=50)
    p.add_argument("--seeds", type=str, default=None,
                   help="comma-separated seed list (e.g. 5,10); overrides --first-seed and "
                        "--num-seeds")
    p.add_argument("--trials", type=int, default=None, help="override the trial count")
    p.add_argument("--scenario-kw", action="append", default=[],
                   help="scenario-config field override as key=value (repeatable, e.g. "
                        "--scenario-kw gp_epochs=500); values parse as Python literals, "
                        "else as strings")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--farm", action=argparse.BooleanOptionalAction, default=None,
                   help="train the seeds as lanes of a SeedFarm: the default for "
                        f"{', '.join(FARMABLE)}; also takes cartpole_mujoco; --no-farm runs "
                        "them one after another")
    p.add_argument("--farm-batch", type=int, default=4, help="seeds per farm batch")
    p.add_argument("--out-tag", type=str, default="",
                   help="suffix of the summary file name, so that A/B arms stay apart")
    p.add_argument("--resume", action="store_true",
                   help="skip the seeds of this scenario/tag's summary; a sequential seed "
                        "continues from its newest completed trial")
    p.add_argument("--device", type=str, default="cuda", help="cpu to run on the CPU")
    args = p.parse_args(argv)
    if args.farm and args.scenario not in FARM_SUPPORTED:
        raise SystemExit(f"--farm does not take {args.scenario} (nor does the JAX package's "
                         f"repeat); it takes {', '.join(FARM_SUPPORTED)}")
    if args.farm is None:
        args.farm = args.scenario in FARMABLE

    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",")]
    else:
        seeds = list(range(args.first_seed, args.first_seed + args.num_seeds))
    results, costs = load_resume(args) if args.resume else ({}, {})
    seeds = [s for s in seeds if s not in results]
    if args.resume and not seeds:
        print("[repeat] resume: nothing left to run")
    (run_farm if args.farm else run_sequential)(args, seeds, results, costs)
    summary, out = write_summary(args, results, costs, complete=True)
    print(json.dumps(summary, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
