"""Time the seed farm's optimizer at each farm batch S, at a fixed number of
iterations per host read (the JAX package's ``scripts/profile_farm.py``).

    python -m mcpilco_tpu_torch.scripts.profile_farm                      # S = 1, 2, 4, 8
    FARM_S=4,8 python -m mcpilco_tpu_torch.scripts.profile_farm
    python -m mcpilco_tpu_torch.scripts.profile_farm --trace-dir results_tmp/torch/farm_traces
    python -m mcpilco_tpu_torch.scripts.profile_farm --smoke --device cpu

For each S: ``SeedFarm`` over the flagship's seeds 1..S
(``scenarios.cartpole``, P=400, horizon 60) with
``chunk_steps_override=40``, the same K at every S, so that the host's
reads and the device's work separate; 6 collections per seed (the final
trial's dataset, N=360), a 300-epoch fit, a warm-up ``improve_policy`` of
120 steps, then a second, timed call of 120 steps.  Reported per S:
``ms_per_seed_step`` (the timed call's seconds over the steps of all
seeds), ``ms_per_batched_step`` (over the most steps of one seed),
``capture_s`` (the warm-up call's seconds: its uncaptured first iteration,
the capture of the CUDA graph and its steps; the JAX script's
``compile_s``), ``steps``, the timed call's host ``reads`` and the
posterior's M.  On the card K1/K2 must run with S lanes.  ``FARM_S`` and
``FARM_GRAM_CHUNK`` (``MultiGP.gram_chunk``, the plain predict) are read
as in the JAX script; ``--trace-dir`` writes a ``torch.profiler`` Chrome
trace per S of a third call of ``TRACE_STEPS`` steps, so that the timed
call runs without the profiler.  The last line of the output is the JSON
object ``{S: row}``, also written to ``--out``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from ..control import trainer
from ..control.mc_pilco import ModelFitOptions, PolicyOptOptions
from ..ops import fused_predict as fp
from ..parallel.multiseed import SeedFarm
from ..scenarios import cartpole as scen


# the farm's chunk_steps_override, the optimizer steps of each call and of a
# trace, the fit's epochs; (steps, epochs) with --smoke
CHUNK, STEPS, TRACE_STEPS, EPOCHS = 40, 120, 3, 300
SMOKE_STEPS, SMOKE_EPOCHS = 4, 30


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="time the seed farm's optimizer per farm batch")
    p.add_argument("--sizes", default=os.environ.get("FARM_S"),
                   help="comma-separated farm batches S (env FARM_S; default 1,2,4,8, with "
                        "--smoke 1,2)")
    p.add_argument("--gram-chunk", type=int, default=int(os.environ.get("FARM_GRAM_CHUNK", "0")),
                   help="MultiGP.gram_chunk: the plain predict in column blocks (env "
                        "FARM_GRAM_CHUNK; 0: off)")
    p.add_argument("--trace-dir", default=os.environ.get("FARM_TRACE_DIR"),
                   help="write a torch.profiler Chrome trace per S here (env FARM_TRACE_DIR)")
    p.add_argument("--smoke", action="store_true",
                   help="the tiny CI config: 2 collections, 30 epochs, 4 steps, S = 1, 2")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join("results_tmp", "torch", "profile_farm.json"))
    return p


def _farm(S, args, dev, epochs):
    """The flagship farm over seeds 1..S, fitted on the final trial's dataset."""
    cfg = scen.CartpoleConfig(seed=1)
    if args.smoke:
        cfg = cfg.smoke()
    agent, _ = scen.build(cfg, dev)
    if args.gram_chunk:
        opt = agent.optimizer
        gp = dataclasses.replace(opt.engine.gp, gram_chunk=args.gram_chunk)
        agent.optimizer = dataclasses.replace(opt, engine=dataclasses.replace(opt.engine, gp=gp))
    farm = SeedFarm(agent, list(range(1, S + 1)),
                    policy_init_fn=lambda k: scen.policy_init(cfg, agent.policy, k, dev),
                    chunk_steps_override=CHUNK)
    farm.collect(cfg.T_exploration, trial_index=0, exploration=True)
    for i in range(1, 2 if args.smoke else 6):  # the final trial's dataset
        farm.collect(cfg.T_control, trial_index=i, exploration=True)
    farm.fit_model(ModelFitOptions(num_epochs=epochs))
    return agent, farm


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    steps, epochs = (SMOKE_STEPS, SMOKE_EPOCHS) if args.smoke else (STEPS, EPOCHS)
    sizes = args.sizes or ("1,2" if args.smoke else "1,2,4,8")
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("profile_farm: no CUDA device (pass --device cpu for the CPU run)", file=sys.stderr)
        return 1
    if cuda:
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    opts = PolicyOptOptions(opt_steps=steps, learning_rate=0.01, p_dropout=0.25)
    out = {}
    for S in (int(v) for v in sizes.split(",")):
        agent, farm = _farm(S, args, dev, epochs)
        sync()
        t0 = time.perf_counter()
        farm.improve_policy(opts, 0)
        sync()
        capture_s = time.perf_counter() - t0
        trainer.reset_graph_counts()
        fp.reset_launches()
        t0 = time.perf_counter()
        _, done, _ = farm.improve_policy(opts, 1)
        sync()
        wall = time.perf_counter() - t0
        if cuda and agent.gp._fused_structure() is not None and not args.gram_chunk and (
                fp.launches["fwd"] == 0 or fp.launched_lanes["fwd"] != S * fp.launches["fwd"]):
            raise RuntimeError(f"S={S}: K1 did not run with {S} lanes: {fp.launches}, "
                               f"lanes {fp.launched_lanes}")
        out[S] = {
            "ms_per_seed_step": 1e3 * wall / max(int(done.sum()), 1),
            "ms_per_batched_step": 1e3 * wall / max(int(done.max()), 1),
            "capture_s": capture_s,
            "steps": int(done.max()),
            "reads": trainer.graph_counts["reads"],
            "M": int(farm.posterior.x_tr.shape[-2]),
        }
        print(f"S={S}: {out[S]}", flush=True)
        if args.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(args.trace_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            short = dataclasses.replace(opts, opt_steps=TRACE_STEPS)
            with profile(activities=acts) as prof:
                farm.improve_policy(short, 2)
                sync()
            prof.export_chrome_trace(os.path.join(args.trace_dir, f"S{S}.json"))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
