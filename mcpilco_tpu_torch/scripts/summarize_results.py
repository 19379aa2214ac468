"""The outcome table of the multi-seed protocol: the port's sweeps beside the
JAX package's records (the JAX package's ``scripts/summarize_results.py``).

    python -m mcpilco_tpu_torch.scripts.summarize_results            # a markdown table
    python -m mcpilco_tpu_torch.scripts.summarize_results --json
    python -m mcpilco_tpu_torch.scripts.summarize_results --dir results_tmp/torch/arm_a

The port's summaries (``repeat``'s ``repeat_*.json``) are read from
``results_tmp/torch/`` under the working directory, where ``repeat`` writes
them, and from the checkout's ``results/torch/``, where finished sweeps are
kept; or from the ``--dir`` directories or files instead.  The JAX
package's records are read as data from the checkout's
``results/repeat_*.json`` (``--jax-dir``).  The sweeps of one scenario and
arm merge seed by seed, a later file (by modification time) over an
earlier one; an arm is the flags and config overrides a sweep passed
(``--smoke`` left out) or, for a file from before summaries held them, a
marker in its name (``AB_ARM_MARKERS``).  The port's summaries also say
whether a sweep was cut to the smoke size or to ``--trials``: such a sweep
is an arm of its own (``--smoke``, ``--trials=N``), so it never merges into
a full sweep's row.  One row per package, scenario
and arm: seeds, successes, rate, the quartiles of the final trial's
cumulative cost (numpy's linear percentiles) and the files, the packages'
rows side by side: they compare as rates and quartiles, never seed
against seed.
"""

import argparse
import glob
import json
import os

import numpy as np

# the checkout's root
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# A/B arms that must not merge into the scenario's own row: newer summaries
# hold the arm ("extra_flags", "scenario_kw"); these file-name markers name
# the arms of files written before that (and arms set by the environment)
AB_ARM_MARKERS = {
    "legacyvar": "MCPILCO_LEGACY_VAR=1",
    "cap2": "--delta-cap=2.0",
}


def arm_label(path, rec) -> str:
    flags = [f for f in rec.get("extra_flags", []) if f != "--smoke"]
    flags += rec.get("scenario_kw", [])
    # a cut-down sweep of the port's (the JAX records hold neither key)
    cut = ["--smoke"] if rec.get("smoke") else []
    cut += [f"--trials={rec['trials']}"] if rec.get("trials") is not None else []
    flags = cut + flags
    if flags:
        return " ".join(flags)
    for marker, label in AB_ARM_MARKERS.items():
        if marker in os.path.basename(path):
            return label
    return ""


def merge(files, root=ROOT) -> dict:
    """The summaries per (scenario, arm): per-seed outcomes and costs, a
    later file's seed over an earlier one's; files named relative to
    ``root``."""
    runs = {}
    for path in sorted(files, key=os.path.getmtime):
        with open(path) as f:
            rec = json.load(f)
        if "per_seed" not in rec:
            continue
        key = (rec["scenario"], arm_label(path, rec))
        entry = runs.setdefault(key, {"per_seed": {}, "per_seed_cost": {}, "files": []})
        entry["per_seed"].update(rec["per_seed"])
        entry["per_seed_cost"].update(rec.get("per_seed_cost", {}))
        entry["files"].append(os.path.relpath(path, root))
    return runs


def quartiles(costs):
    if not costs:
        return None
    arr = np.asarray(sorted(costs), np.float64)
    return {
        "q25": round(float(np.percentile(arr, 25)), 3),
        "median": round(float(np.percentile(arr, 50)), 3),
        "q75": round(float(np.percentile(arr, 75)), 3),
        "min": round(float(arr.min()), 3),
        "max": round(float(arr.max()), 3),
    }


def rows(runs: dict, package: str) -> list:
    """One row per (scenario, arm) of :func:`merge`'s runs, the package named."""
    out = []
    for (scenario, arm), e in sorted(runs.items()):
        outcomes = {int(k): bool(v) for k, v in e["per_seed"].items() if v is not None}
        n, wins = len(outcomes), sum(outcomes.values())
        costs = [v for k, v in e["per_seed_cost"].items()
                 if v is not None and outcomes.get(int(k)) is not None]
        out.append({
            "scenario": scenario + (f" [{arm}]" if arm else ""),
            "package": package,
            "seeds": n,
            "successes": wins,
            "rate": round(wins / n, 3) if n else None,
            "cost_quartiles": quartiles(costs),
            "artifacts": e["files"],
        })
    return out


def summary_files(paths) -> list:
    """The ``repeat_*.json`` files of ``paths`` (directories or files), each once."""
    found = {}
    for path in paths:
        for f in ([path] if os.path.isfile(path) else
                  glob.glob(os.path.join(path, "repeat_*.json"))):
            found.setdefault(os.path.realpath(f), f)
    return list(found.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the multi-seed outcomes of both packages")
    p.add_argument("--json", action="store_true", help="print the rows as JSON")
    p.add_argument("--dir", action="append", default=None,
                   help="a directory of the port's summaries, or a summary (repeatable; "
                        "default results_tmp/torch and the checkout's results/torch)")
    p.add_argument("--jax-dir", default=os.path.join(ROOT, "results"),
                   help="the JAX package's records")
    args = p.parse_args(argv)
    mine = args.dir or [os.path.join("results_tmp", "torch"),
                        os.path.join(ROOT, "results", "torch")]
    table = sorted(rows(merge(summary_files(mine)), "torch")
                   + rows(merge(summary_files([args.jax_dir])), "jax"),
                   key=lambda r: (r["scenario"], r["package"]))
    if args.json:
        print(json.dumps(table, indent=1))
        return 0
    print("| Scenario | Package | Seeds | Success | Cost q25/med/q75 | Artifacts |")
    print("|---|---|---|---|---|---|")
    for r in table:
        q = r["cost_quartiles"]
        qs = f"{q['q25']} / {q['median']} / {q['q75']}" if q else "—"
        rate = f" ({100 * r['rate']:.0f}%)" if r["rate"] is not None else ""
        print(f"| {r['scenario']} | {r['package']} | {r['seeds']} | "
              f"{r['successes']}/{r['seeds']}{rate} | {qs} | {', '.join(r['artifacts'])} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
