"""Hold the port's outcome sweeps against the JAX package's records by the
decision rule of the outcome protocol.

    python -m mcpilco_tpu_torch.scripts.outcome_parity          # the committed sweeps
    python -m mcpilco_tpu_torch.scripts.outcome_parity --port results_tmp/torch --json
    python -m mcpilco_tpu_torch.scripts.outcome_parity --jax-rows results/analyze_furuta_failures_r3.json

A scenario matches its JAX record when both hold:

(a) Fisher's exact test (two-sided) on the success counts gives p >= 0.05;
(b) the median final cost of the port's successes lies within the JAX
    successes' q25-q75.

A sweep whose summary says ``"complete": false`` (cut by a stop, a watchdog
or the chip time) is not decided: its row says so and carries no match.
Beside the rule each row carries the rank test of the two packages'
successes' costs and that of all their seeds' costs (Mann-Whitney U,
two-sided), as evidence only: neither enters the verdict.

Rates and quartiles are compared, never seed against seed: a one-ulp change
re-rolls a seed's outcome.  The port's summaries (``repeat``'s
``repeat_*.json``) come from ``--port`` (directories or files; by default
``results/torch/``, where finished sweeps are kept), merged per scenario and
arm as ``summarize_results`` merges them.  Each (scenario, arm) is held
against the JAX record that ran its config (``RECORDS``, files of the
checkout's ``results/``).  Quartiles are numpy's linear percentiles.  Needs
scipy (``fisher_exact``, ``mannwhitneyu``); it reads files only and runs on
any host.
"""

import argparse
import json
import os

import numpy as np

from .summarize_results import ROOT, merge, summary_files

# (scenario, arm) -> the JAX package's records of that config
RECORDS = {
    ("cartpole", ""): ["results/repeat_cartpole_50seeds_farm_r3.json"],
    ("cartpole_pms", ""): ["results/repeat_pms5_50seeds_r3.json"],
    ("cartpole_multi_init", ""): ["results/repeat_multiinit_50seeds_r3.json"],
    ("furuta", ""): ["results/repeat_furuta_seeds2-3.json",
                     "results/repeat_furuta_seeds4-10.json"],
    ("cartpole_pms", "MCPILCO_LEGACY_VAR=1"): [
        "results/repeat_cartpole_pms_5trials_legacyvar_r3.json"],
}
P_MIN = 0.05


def _quartiles(costs):
    if not costs:
        return None
    q = np.percentile(np.asarray(costs, np.float64), [25, 50, 75])
    return {"q25": float(q[0]), "median": float(q[1]), "q75": float(q[2])}


def outcome(entry) -> dict:
    """Seeds, successes, and the cost quartiles of the successes and of all
    seeds of one merged (scenario, arm)."""
    ok = {int(k): bool(v) for k, v in entry["per_seed"].items() if v is not None}
    cost = {int(k): v for k, v in entry["per_seed_cost"].items() if v is not None}
    won = [cost[s] for s in ok if ok[s] and s in cost]
    every = [cost[s] for s in ok if s in cost]
    return {"seeds": len(ok), "successes": sum(ok.values()),
            "rate": sum(ok.values()) / len(ok) if ok else None,
            "success_cost": _quartiles(won), "success_costs": won,
            "all_cost": _quartiles(every), "all_costs": every}


def rank_p(port: dict, ref: dict, key: str = "success_costs"):
    """Mann-Whitney U (two-sided) of the port's successes' costs (``key``
    "all_costs": every seed's) against the JAX ones, or None where either
    side has none."""
    from scipy.stats import mannwhitneyu

    a, b = port[key], ref[key]
    if not a or not b:
        return None
    return float(mannwhitneyu(a, b, alternative="two-sided").pvalue)


def verdict(port: dict, ref: dict) -> dict:
    """The decision rule on two :func:`outcome` s."""
    from scipy.stats import fisher_exact

    table = [[port["successes"], port["seeds"] - port["successes"]],
             [ref["successes"], ref["seeds"] - ref["successes"]]]
    p = float(fisher_exact(table, alternative="two-sided")[1])
    ps, rs = port["success_cost"], ref["success_cost"]
    in_iqr = bool(ps is not None and rs is not None
                  and rs["q25"] <= ps["median"] <= rs["q75"])
    return {"fisher_p": p, "rate_ok": p >= P_MIN, "median_in_jax_iqr": in_iqr,
            "match": p >= P_MIN and in_iqr}


def _complete(path) -> bool:
    with open(path) as f:
        return json.load(f).get("complete", True) is not False


def rows_entry(path) -> dict:
    """A failure analysis's rows (``analyze_mujoco_failures --json``: a list
    of per-seed rows) as a merged entry: each seed's executed success and
    cost."""
    with open(path) as f:
        found = json.load(f)
    return {"scenario": found[0]["scenario"],
            "per_seed": {str(r["seed"]): bool(r["executed_success"]) for r in found},
            "per_seed_cost": {str(r["seed"]): r["executed_cost"] for r in found}}


def rows(port_paths, root=ROOT, jax_rows=None) -> list:
    """One row per (scenario, arm) of the port's summaries that has a JAX
    record (``RECORDS``), or with ``jax_rows`` (an analysis's rows file)
    that file as the reference of its scenario's own arm."""
    ref_rows = rows_entry(jax_rows) if jax_rows else None
    out = []
    for (scenario, arm), entry in sorted(merge(summary_files(port_paths), root).items()):
        if ref_rows is not None:
            if (scenario, arm) != (ref_rows["scenario"], ""):
                continue
            jax_files, ref_entry = [os.path.relpath(jax_rows, root)], ref_rows
        else:
            jax_files = RECORDS.get((scenario, arm))
            if jax_files is None:
                continue
            ref = merge([os.path.join(root, f) for f in jax_files], root)
            (ref_entry,) = ref.values()
        port, jax = outcome(entry), outcome(ref_entry)
        complete = all(_complete(os.path.join(root, f)) for f in entry["files"])
        rule = verdict(port, jax)
        if not complete:
            rule["match"] = None
        out.append({"scenario": scenario + (f" [{arm}]" if arm else ""), "port": port,
                    "jax": jax, "complete": complete, **rule,
                    "mannwhitney_p": rank_p(port, jax),
                    "mannwhitney_all_p": rank_p(port, jax, "all_costs"),
                    "port_files": entry["files"],
                    "jax_files": jax_files})
    return out


def _fmt(q):
    return "-" if q is None else f"{q['q25']:.3f} / {q['median']:.3f} / {q['q75']:.3f}"


def main(argv=None) -> list:
    p = argparse.ArgumentParser("outcome_parity")
    p.add_argument("--port", action="append", default=None,
                   help="the port's summaries: directories or files (repeatable; default "
                        "results/torch)")
    p.add_argument("--json", action="store_true", help="print the rows as JSON")
    p.add_argument("--jax-rows", default=None, metavar="FILE",
                   help="hold the port against a JAX failure analysis's rows (e.g. "
                        "results/analyze_furuta_failures_r3.json) instead of RECORDS")
    args = p.parse_args(argv)
    found = rows(args.port or [os.path.join(ROOT, "results", "torch")],
                 jax_rows=args.jax_rows)
    if args.json:
        print(json.dumps(found, indent=1))
        return found
    print("| scenario | port | port successes' cost q25 / median / q75 | port all seeds' "
          "cost | JAX | JAX successes' cost | Fisher p | verdict | successes' rank p "
          "(evidence) | all seeds' rank p (evidence) |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in found:
        pt, jx = r["port"], r["jax"]
        if not r["complete"]:
            print(f"| {r['scenario']} | {pt['successes']}/{pt['seeds']} (sweep incomplete) "
                  f"| {_fmt(pt['success_cost'])} | {_fmt(pt['all_cost'])} "
                  f"| {jx['successes']}/{jx['seeds']} | {_fmt(jx['success_cost'])} | - "
                  f"| not decided | - | - |")
            continue
        print(f"| {r['scenario']} | {pt['successes']}/{pt['seeds']} | {_fmt(pt['success_cost'])} "
              f"| {_fmt(pt['all_cost'])} | {jx['successes']}/{jx['seeds']} "
              f"| {_fmt(jx['success_cost'])} | {r['fisher_p']:.3f} "
              f"| {'match' if r['match'] else 'no match'}"
              f"{'' if r['rate_ok'] else ' (rate)'}"
              f"{'' if r['median_in_jax_iqr'] else ' (median)'} "
              f"| {'-' if r['mannwhitney_p'] is None else format(r['mannwhitney_p'], '.2g')} "
              f"| {'-' if r['mannwhitney_all_p'] is None else format(r['mannwhitney_all_p'], '.2g')} |")
    return found


if __name__ == "__main__":
    main()
