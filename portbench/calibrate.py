#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the
cell's own size, without a measured window (a training cell's readings need
none):

    python3 portbench/calibrate.py --workload cartpole.opt --seeds 1,2,3 \\
        --variants program,control,half_batch

For each seed it runs the cell's set-up and warm-up call through the port,
then the float64 reference of that call, and compares with it (``check.py``)
each variant put in the port's place:

- ``program``: the port's own call (the sound runs; their largest reading
  is a number's lower reading);
- ``float32``: the reference at the configuration's precision, float32 with
  TF32 off (how far float32 alone sits from float64);
- ``control``: the reference in the nearest precision below the
  configuration's: float32 with TF32 on in matmuls and cuDNN;
- ``half_batch``, ``half_gradient``, ``cost_altered``,
  ``prediction_altered``, ``grad_negated``: the float32 reference with a
  fault planted (``reference.common.FAULTS``).  A state left unchanged reads 1 on
  ``unmoved`` by its measure and needs no run.

Prints one JSON line per seed and variant, and writes them all to ``--out``.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {  # variant -> (TF32 in matmuls and cuDNN, planted fault)
    "float32": (False, None),
    "control": (True, None),
    "half_batch": (False, "half_batch"),
    "half_gradient": (False, "half_gradient"),
    "cost_altered": (False, "cost_altered"),
    "prediction_altered": (False, "prediction_altered"),
    "grad_negated": (False, "grad_negated"),
}


def readings(name: str, seed: int, variants, device, sizes=None):
    """Yields (variant, its compared numbers and first costs) for one seed;
    first ("reference", the float64 reference's first cost and each lane's
    gram condition numbers and jitter scale)."""
    import torch

    from portbench import check, harness
    from portbench.reference import common as ref

    cell, cfg = harness.load_cell(name)
    sizes = sizes or {}
    cfg = dict(cfg, **sizes.get("config", {}))
    cfg["data"] = dict(cfg["data"], **sizes.get("data", {}))
    cfg["policy"] = dict(cfg["policy"], **sizes.get("policy", {}))
    cell = dict(cell, **sizes.get("cell", {}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = harness.Run(cell=cell, cfg=cfg, seed=seed, device=torch.device(device), lanes=[])
    before, warm = harness.setup(run, sizes.get("scenario", {}))
    run.system.close()
    judged = harness.judges(run, before)
    conds = [[float(torch.linalg.cond(h.A)) for h in j["heads"]] + [j["jitter_scale"]]
             for j in judged]
    yield "reference", {"cost0": [j["cost0"] for j in judged], "cond_and_scale": conds}
    mod = harness.inp.reference_module(cfg)

    def leaves(calls):
        """Per lane, step and leaf: (reference norm, port norm, difference, median)."""
        return [check.grad_leaves(mod, cfg, j["heads"], c, j["key"])
                for j, c in zip(judged, calls)]

    if "program" in variants:
        yield "program", dict(harness.numbers(run, judged, warm, before), grad=leaves(warm),
                              costs=[[float(c) for c in w["costs"]] for w in warm],
                              M=run.info.get("M"), jitter=run.info.get("jitter_scale"))
    for v in variants:
        if v == "program":
            continue
        tf32, fault = VARIANTS[v]
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            got = []
            for i, lane in enumerate(run.lanes):
                heads, _ = ref.posterior(mod, cfg, lane, torch.float32, run.device)
                r = ref.run_steps(mod, cfg, heads, before[i], judged[i]["key"],
                                  cell["check_steps"], torch.float32, run.device, fault=fault)
                got.append(dict(costs=r["costs"], steps_done=len(r["costs"]),
                                states=r["states"], inputs=r["inputs"], trace=r["trace"]))
                del heads
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        yield v, dict(harness.numbers(run, judged, got, before), grad=leaves(got),
                      costs=[g["costs"] for g in got])
        del got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the readings a cell's limits are set from")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variants", default="program,float32,control,half_batch,half_gradient,"
                                         "cost_altered,prediction_altered")
    p.add_argument("--check-steps", type=int, default=None,
                   help="the warm-up call's steps, in place of the cell's")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    variants = args.variants.split(",")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        sizes = {} if args.check_steps is None else {"cell": {"check_steps": args.check_steps}}
        for v, r in readings(args.workload, seed, variants, "cuda:0", sizes):
            row = dict(workload=args.workload, seed=seed, variant=v, **r)
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"[calibrate] seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
