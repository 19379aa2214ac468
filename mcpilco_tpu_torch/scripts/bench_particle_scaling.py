"""Particle-count sweep of the flagship's policy-optimization step: ms per
step and per particle-step (the JAX package's
``scripts/bench_particle_scaling.py``).

    python -m mcpilco_tpu_torch.scripts.bench_particle_scaling                  # P = 400..3200
    python -m mcpilco_tpu_torch.scripts.bench_particle_scaling 400,1600
    python -m mcpilco_tpu_torch.scripts.bench_particle_scaling --quick --device cpu

One dataset and one fitted GP for every P: the flagship
(``scenarios.cartpole``), 6 exploration trials (N=360), a 1501-epoch fit.
Then for each P in the positional list (default ``400,800,1600,3200``):

1. ``MultiGP.predict`` at P particles (on the card K1, and K2 in the
   backward) against ``MultiGP._predict_plain``: mean and variance at
   FWD_TOL, x*'s gradient at GRAD_TOL (``ops.fused_predict``'s, those of
   ``chip_smoke.py``), on a posterior drawn at the fitted one's shape (its
   M and the flagship's kernel, the polynomial terms at 0.1 of their unit
   scale: ``_drawn_posterior``), and
   on the fitted posterior both paths against float64 (the kernel no less
   accurate than the plain path).  A mismatch ends the run with exit code 1
   before any timing.  On the card the device time of one K1 and one K2
   launch at that P (``torch.profiler`` kernel records) is reported beside
   their bound (``fused_predict.k1_work`` / ``k2_work``).
2. A fresh optimizer at P particles: a 20-step warm-up ``optimize`` (key 7;
   its seconds are ``capture_s``: the uncaptured first iteration, the CUDA
   graph's capture and the steps), then a timed 100-step call (key
   ``fold(7, 1)``): ``ms_per_step`` (wall over the steps run),
   ``replay_ms_per_step`` (the optimizer's own clock of its graph replays),
   ``us_per_particle_step``, K1/K2 launches per step and the first and last
   cost.

``--quick`` is the CPU size (the smoke config, 2 trials, a 101-epoch fit,
5 + 20 steps).  The last line of the output is the JSON object ``{P:
row}``, also written to ``--out``.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..control import trainer
from ..control.mc_pilco import ModelFitOptions
from ..models.gp import Posterior, tree_map
from ..ops import fused_predict as fp
from ..ops.fused_predict import FWD_TOL, GRAD_TOL
from ..scenarios import cartpole as scen
from ..utils import prng
from ..utils.profiling import bound, device_records

def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the flagship step's time over the particle count")
    p.add_argument("counts", nargs="?", default="400,800,1600,3200",
                   help="comma-separated particle counts")
    p.add_argument("--quick", action="store_true", help="the CPU size")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=os.path.join("results_tmp", "torch",
                                                 "bench_particles_latest.json"))
    return p


def _drawn_posterior(gp, post, P, dev, seed):
    """(params, posterior, x*) drawn at the shape of ``post``: unit-scale
    lengthscales, the polynomial terms at 0.1, alpha ~ N(0, 1), F at 0.005
    N(0, 1), every head's mask of 80% of the points, x* ~ N(0, 1)."""
    G, (M, D) = gp.num_heads, post.x_tr.shape[-2:]
    members = len(getattr(gp.kernel, "members", ()))
    unit, small = {"lengthscales": 1.0}, {"sigma_diag": math.sqrt(0.1)}
    over = {"member_overrides": [unit] + [small] * (members - 1)} if members else unit
    params = gp.init_params(per_head_overrides=[over] * G, device=dev)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    drawn = Posterior(x_tr=t(rng.standard_normal((M, D))),
                      mask=t(rng.uniform(size=(G, M)) > 0.2),
                      alpha=t(rng.standard_normal((G, M))),
                      var_factor=t(0.005 * rng.standard_normal((G, M, M))),
                      norm=torch.ones(G, device=dev))
    return params, drawn, t(rng.standard_normal((P, D)))


def _fwd_bwd(fn, params, post, xs):
    xs = xs.clone().requires_grad_(True)
    mean, var = fn(params, post, xs)
    G, P = mean.shape
    wk = torch.linspace(0.5, 1.5, G * P, device=xs.device).reshape(G, P)
    wq = torch.linspace(-1.0, 1.0, G * P, device=xs.device).reshape(G, P)
    grad = torch.autograd.grad(torch.sum(wk * mean) + torch.sum(wq * var), xs)[0]
    return mean.detach(), var.detach(), grad


def check_predict(agent, P, dev) -> dict:
    """Step 1 of the module docstring at P particles; raises on a mismatch.
    Returns the errors and, on the card, K1/K2's device us and bounds."""
    gp, cuda = agent.gp, dev.type == "cuda"
    params, post, xs = _drawn_posterior(gp, agent.posterior, P, dev, seed=P)
    fp.reset_launches()
    got = _fwd_bwd(gp.predict, params, post, xs)
    launches = dict(fp.launches)
    ref = _fwd_bwd(gp._predict_plain, params, post, xs)
    structure = gp._fused_structure()
    if cuda and structure is not None and launches != {"fwd": 1, "bwd": 1}:
        raise RuntimeError(f"P={P}: predict launched {launches}, not K1 and K2 once each")
    for a, b, tol in zip(got, ref, (FWD_TOL, FWD_TOL, GRAD_TOL)):
        torch.testing.assert_close(a, b, **tol)
    row = {"predict_err": max(float(torch.max(torch.abs(a - b))) for a, b in zip(got, ref))}
    # the fitted posterior: both fp32 paths against float64
    rng = np.random.default_rng(P)
    x_fit = torch.as_tensor(agent.gp_x[rng.integers(0, len(agent.gp_x), P)], device=dev)
    to64 = lambda tree: tree_map(torch.Tensor.double, tree)
    with torch.no_grad():
        m64, v64 = gp._predict_plain(to64(agent.gp_params), to64(agent.posterior),
                                     x_fit.double())
        errs = {}
        for name, fn in (("plain", gp._predict_plain), ("predict", gp.predict)):
            m, v = fn(agent.gp_params, agent.posterior, x_fit)
            errs[name] = (float(torch.max(torch.abs(m.double() - m64))),
                          float(torch.max(torch.abs(v.double() - v64))))
    if not all(map(math.isfinite, errs["plain"] + errs["predict"])) or any(
            errs["predict"][i] > 4 * errs["plain"][i] + 1e-6 for i in (0, 1)):
        raise RuntimeError(f"P={P}: predict on the fitted posterior against float64: {errs}")
    row["fitted_err_vs_f64"] = errs
    if cuda and structure is not None:
        row.update(_kernel_times(gp, params, post, xs, P, structure == "se+p2"))
    return row


def _kernel_times(gp, params, post, xs, P, use_poly, iters=20):
    """Device us of one K1 and one K2 launch at P (profiler kernel records
    over ``iters`` forward + backward calls) and their bounds."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        _fwd_bwd(gp.predict, params, post, xs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            _fwd_bwd(gp.predict, params, post, xs)
        torch.cuda.synchronize()
    per = {}
    for name, us in device_records(prof):
        per[name] = per.get(name, 0.0) + us / iters
    named = lambda name: sum(t for k, t in per.items() if name in k)
    G, (M, D) = gp.num_heads, post.x_tr.shape[-2:]
    b1 = bound(fp.k1_work(1, P, M, use_poly, G, D))
    b2 = bound(fp.k2_work(1, P, M, use_poly, G, D))
    return {"k1_us": named("k1_forward"), "sum_partials_us": named("sum_partials"),
            "k1_bound_us": 1e3 * b1[0], "k2_us": named("k2_backward_xstar"),
            "k2_bound_us": 1e3 * b2[0]}


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("bench_particle_scaling: no CUDA device (pass --device cpu for the CPU run)",
              file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counts = [int(c) for c in args.counts.split(",")]
    cfg = scen.CartpoleConfig(seed=1)
    if args.quick:
        cfg = cfg.smoke()
    agent, _ = scen.build(cfg, dev)
    for i in range(2 if args.quick else 6):
        agent.collect(cfg.T_exploration, trial_index=i, exploration=True)
    agent.fit_model(ModelFitOptions(num_epochs=101 if args.quick else 1501))
    print(f"[particles] {torch.cuda.get_device_name(dev) if cuda else 'cpu'}: dataset "
          f"N={agent.gp_x.shape[0]}, M={agent.posterior.x_tr.shape[-2]}", flush=True)
    checks = {}
    for P in counts:
        try:
            checks[P] = check_predict(agent, P, dev)
        except (AssertionError, RuntimeError) as err:
            print(f"[particles] P={P}: predict against _predict_plain FAILED: {err}",
                  file=sys.stderr)
            return 1
        print(f"[particles] P={P}: predict against _predict_plain {checks[P]}", flush=True)
    warm, timed = (5, 20) if args.quick else (20, 100)
    key = prng.root_key(7)
    results = {}
    for P in counts:
        opt = scen.build(dataclasses.replace(cfg, num_particles=P), dev)[0].optimizer
        run = lambda k, n: opt.optimize(k, agent.policy_params, agent.gp_params,
                                        agent.posterior, n, 0.01, 0.25)
        sync()
        t0 = time.perf_counter()
        run(key, warm)
        sync()
        capture_s = time.perf_counter() - t0
        trainer.reset_graph_counts()
        fp.reset_launches()
        t0 = time.perf_counter()
        res = run(prng.fold(key, 1), timed)
        sync()
        wall = time.perf_counter() - t0
        steps = int(res.steps_done)
        ms = 1e3 * wall / max(steps, 1)
        replays = trainer.graph_counts["replays"]
        c = res.cost_history.numpy()
        results[P] = {
            "ms_per_step": ms,
            "replay_ms_per_step": (1e3 * trainer.graph_counts["replays_s"] / replays
                                   if replays else None),
            "us_per_particle_step": 1e3 * ms / P,
            "capture_s": capture_s,
            "steps": steps,
            "k1_per_step": fp.launches["fwd"] / max(steps, 1),
            "k2_per_step": fp.launches["bwd"] / max(steps, 1),
            "cost_first_last": [float(c[0]), float(c[steps - 1])],
            **checks[P],
        }
        print(f"[particles] P={P}: {ms:.2f} ms/step ({1e3 * ms / P:.3f} us/particle-step), "
              f"capture {capture_s:.2f} s, costs {results[P]['cost_first_last']}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
