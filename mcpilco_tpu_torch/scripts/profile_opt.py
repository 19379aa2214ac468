"""Profile the flagship's policy-optimization step, graphed and uncaptured,
and graphed over a sweep of the iterations per host read.

    python -m mcpilco_tpu_torch.scripts.profile_opt                      # on the card
    python -m mcpilco_tpu_torch.scripts.profile_opt --chunk 1,4,16,64 --trace-dir results_tmp/torch/trace
    python -m mcpilco_tpu_torch.scripts.profile_opt --smoke --device cpu --steps 2 --chunk 1,2

Builds the flagship (``scenarios.cartpole``), collects 6 exploration
trials, fits the GP, then times ``PolicyOptimizer.optimize`` per step in
turns: with the step captured as a CUDA graph at the default iterations
per host read ("graph"), at each ``--chunk`` K ("chunk=K"), and uncaptured
(``graph=False``): host ms/step, and on the card device busy ms/step, the
device's idle time inside one replay of the graph (its gaps between
kernels), device events and host CUDA API calls per step and the idle
share (``utils/profiling.profile_steps``), and the host reads per call.
Host minus busy splits into the gaps inside the replays and what is left
between them (the host part, which more iterations per read hide).  ``--trace-dir`` writes a
Chrome trace of each mode's profiled window.  On the CPU only the
uncaptured host time is measured (at each K); the device figures are null
("not measured").  The report is printed and written as JSON to ``--out``.
"""

import argparse
import json
import os
import sys
import time

import torch

from ..control.mc_pilco import ModelFitOptions
from ..control.trainer import GRAPH_WARMUP, graph_counts, reset_graph_counts
from ..scenarios import cartpole as scen
from ..utils import prng
from ..utils.profiling import GRAPH_BASE, host_ms, profile_steps


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="profile the flagship's policy-optimization step")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--steps", type=int, default=64, help="optimizer steps per host window")
    p.add_argument("--chunk", default="",
                   help="comma-separated iterations per host read to sweep, graphed")
    p.add_argument("--window", type=int, default=3, help="optimizer steps per profiled window")
    p.add_argument("--turns", type=int, default=2, help="host windows per mode, in turns")
    p.add_argument("--epochs", type=int, default=1501, help="GP fit epochs")
    p.add_argument("--smoke", action="store_true", help="the tiny CI config")
    p.add_argument("--trace-dir", default=None, help="write Chrome traces of the windows here")
    p.add_argument("--out", default=os.path.join("results_tmp", "torch", "profile_opt.json"))
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("profile_opt: no CUDA device (pass --device cpu for the host-only run)",
              file=sys.stderr)
        return 1
    cfg = scen.CartpoleConfig(seed=args.seed)
    if args.smoke:
        cfg = cfg.smoke()
    agent, _ = scen.build(cfg, dev)
    for i in range(6):
        agent.collect(cfg.T_exploration, trial_index=i, exploration=True)
    t0 = time.perf_counter()
    agent.fit_model(ModelFitOptions(num_epochs=args.epochs))
    fit_s = time.perf_counter() - t0
    opt = agent.optimizer

    def runner(graph, chunk, mode):
        def run(n):
            reset_graph_counts()
            opt.optimize(prng.fold(prng.root_key(7), 1), agent.policy_params, agent.gp_params,
                         agent.posterior, n, 0.01, 0.25, graph=graph, chunk=chunk)
            if cuda:
                torch.cuda.synchronize()
            reads.setdefault(mode, []).append(graph_counts["reads"])
        return run

    sweep = [int(v) for v in args.chunk.split(",") if v]
    # mode -> (graph, chunk); on the CPU every mode runs uncaptured
    modes = {"graph": (True, None)} if cuda else {}
    modes.update({f"chunk={k}": (cuda, k) for k in sweep})
    modes["uncaptured"] = (False, None)
    host, rows, reads = {m: [] for m in modes}, {}, {}
    for turn in range(args.turns):
        for mode in (list(modes) if turn % 2 == 0 else reversed(list(modes))):
            graph, chunk = modes[mode]
            run = runner(graph, chunk, mode)
            base = GRAPH_BASE if graph else 1
            if not cuda:
                host[mode] += host_ms(run, args.steps, base)
                continue
            trace = None
            if args.trace_dir and turn == 0:
                os.makedirs(args.trace_dir, exist_ok=True)
                trace = os.path.join(args.trace_dir, f"profile_opt_{mode}.json")
            p = profile_steps(run, host_steps=args.steps, window=args.window, base=base,
                              trace_path=trace)
            host[mode].append(p["host_ms"])
            if mode not in rows:
                rows[mode] = {k: p[k] for k in ("busy_ms", "gap_ms", "replays_seen", "events",
                                                "api_calls", "idle")}
                rows[mode]["api_by_name"] = dict(list(p["api_by_name"].items())[:6])
    report = dict(
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
        shapes=dict(P=opt.num_particles, H=opt.horizon, G=agent.gp.num_heads,
                    M=int(agent.posterior.x_tr.shape[-2]), D=agent.model.gp_input_dim,
                    basis=agent.policy.num_basis),
        fit_s=fit_s, steps=args.steps, graph_warmup=GRAPH_WARMUP,
        modes={m: dict(host_ms=host[m], reads_per_call=reads[m][0],
                       **rows.get(m, dict(busy_ms=None, gap_ms=None, replays_seen=None,
                                          events=None, api_calls=None, idle=None)))
               for m in modes},
    )
    for m, r in report["modes"].items():
        gap = ("no replay" if r["gap_ms"] is None else
               f"{r['gap_ms']:.3f} ms idle inside a replay (least of {r['replays_seen']})")
        busy = "not measured" if r["busy_ms"] is None else (
            f"{r['busy_ms']:.3f} ms busy, {gap}, {r['events']:.0f} events, "
            f"{r['api_calls']:.0f} API calls per step, idle {r['idle']:.3f}")
        print(f"[profile_opt] {m}: host ms/step {' / '.join(f'{v:.3f}' for v in r['host_ms'])};"
              f" {r['reads_per_call']} host reads in the first call;"
              f" {busy}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
