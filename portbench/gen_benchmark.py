#!/usr/bin/env python3
"""Writes ``BENCHMARK.json`` from the benchmark's own files, so that a new
configuration, cell or metric is a new file and nothing else:

- ``settings.json``: the command, the paths and ``run_seconds``;
- ``configs/<name>.json``: a configuration (its ``name``, ``source``,
  ``reduced`` and ``why``);
- ``workloads/<name>.json``: a cell (``name``, ``config``, ``traffic``,
  ``chips``, ``why``), in the order of their ``rank``;
- ``end_to_end/<name>.json``: an end-to-end metric with its bound;
- ``metrics/<name>.py``: a per-layer metric (``harness.metric_modules``).

    python3 portbench/gen_benchmark.py            # writes BENCHMARK.json
    python3 portbench/gen_benchmark.py --check    # exit 1 if it is stale
"""

import argparse
import glob
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path):
    with open(path) as f:
        return json.load(f)


def _metric_modules(root):
    sys.path.insert(0, os.path.dirname(HERE))
    from portbench.harness import metric_modules

    return metric_modules(root)


def benchmark(root: str = HERE) -> dict:
    """The contents of BENCHMARK.json for the benchmark folder ``root``."""
    rel = os.path.basename(root)
    out = dict(_load(os.path.join(root, "settings.json")))
    out["configs"] = []
    for p in sorted(glob.glob(os.path.join(root, "configs", "*.json"))):
        c = _load(p)
        out["configs"].append({"name": c["name"], "source": c["source"],
                               "file": f"{rel}/configs/{os.path.basename(p)}",
                               "reduced": c["reduced"], "why": c["why"]})
    cells = [_load(p) for p in glob.glob(os.path.join(root, "workloads", "*.json"))]
    out["workloads"] = [{k: w[k] for k in ("name", "config", "traffic", "chips", "why")}
                        for w in sorted(cells, key=lambda w: (w["rank"], w["name"]))]
    out["end_to_end"] = [_load(p) for p in
                         sorted(glob.glob(os.path.join(root, "end_to_end", "*.json")))]
    out["per_layer"] = []
    for m in _metric_modules(root):
        entry = {"name": m.NAME, "unit": m.UNIT, "better": m.BETTER, "source": m.SOURCE,
                 "layer": m.LAYER, "moves": m.MOVES}
        if m.WORKLOADS is not None:
            entry["workloads"] = list(m.WORKLOADS)
        out["per_layer"].append(entry)
    return out


def render(bench: dict) -> str:
    return json.dumps(bench, indent=2) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="write BENCHMARK.json from portbench's files")
    p.add_argument("--check", action="store_true", help="only check that it is current")
    p.add_argument("--out", default=os.path.join(os.path.dirname(HERE), "BENCHMARK.json"))
    args = p.parse_args(argv)
    text = render(benchmark())
    if args.check:
        with open(args.out) as f:
            same = f.read() == text
        print("BENCHMARK.json is " + ("current" if same else "stale"))
        return 0 if same else 1
    with open(args.out, "w") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
