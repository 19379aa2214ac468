#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mcpilco_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line with its time; any failure exits non-zero):

1. build the fused GP-predict kernels K1/K2 from ``csrc/`` with nvcc;
2. hold K1 and x*'s gradient through K2 against the plain PyTorch twin at
   G=2, D=6, M=384 and P in {400, 37} (and at M=100, P=37, a ragged edge),
   for 'se' and 'se+p2', and time kernel against twin at M=384;
3. the flagship policy-optimization step: 6 exploration trials (N~360),
   a 1501-epoch GP fit with the SOD posterior, 30 optimizer steps;
4. the main path through the user's entry points: ``build`` then
   ``reinforce`` for 2 trials at full width, with the kernel launch counts
   of that run.

There is no CPU path: without a CUDA device the script exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their launches, errors and times.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

FWD_TOL = dict(rtol=2e-5, atol=1e-5)  # tests/test_fused_predict.py:32
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_fused_predict.py:65
G, D, M_FLAGSHIP = 2, 6, 384


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_facts():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)


def kernel_inputs(P, M, seed, dev):
    """Seeded inputs shaped like one rollout step's predict call."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)
    arrs = [
        np.exp(0.3 * f(G, D)), np.exp(0.2 * f(G)), 0.1 * np.exp(0.3 * f(G, D + 1)),
        0.1 * np.exp(0.3 * f(G, D)), 0.1 * np.exp(0.3 * f(G, D)), f(P, D), f(M, D),
        f(G, M), 0.05 * f(G, M, M), (rng.uniform(size=(G, M)) > 0.2).astype(np.float64),
    ]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def cuda_ms(fn, iters=100, warmup=10):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float(torch.max(torch.abs(a - b)))


def check_kernels(fp, dev):
    """Phase 2: K1 and K2 against the twin; returns per-kernel records."""
    rec = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    for use_poly in (False, True):
        # M=100 exercises the ragged edge of K2's F tiles (the main path's
        # SOD buckets are multiples of 64); it is checked, not timed
        for P, M in ((400, M_FLAGSHIP), (37, M_FLAGSHIP), (37, 100)):
            args = kernel_inputs(P, M, seed=P + M + 10 * use_poly, dev=dev)
            ka, qd = fp.fused_gram_contract(*args, use_poly)
            ka_r, qd_r = fp.reference_gram_contract(*args, use_poly)
            torch.cuda.synchronize()
            torch.testing.assert_close(ka, ka_r, **FWD_TOL)
            torch.testing.assert_close(qd, qd_r, **FWD_TOL)
            e_fwd = max(max_err(ka, ka_r), max_err(qd, qd_r))

            wk = torch.linspace(0.5, 1.5, G * P, device=dev).reshape(G, P)
            wq = torch.linspace(-1.0, 1.0, G * P, device=dev).reshape(G, P)

            def grad(fn):
                xs = args[5].clone().requires_grad_(True)
                a = list(args)
                a[5] = xs
                ka_, qd_ = fn(*a, use_poly)
                return torch.autograd.grad(torch.sum(wk * ka_) + torch.sum(wq * qd_), xs)[0]

            g_k = grad(fp.gram_contract)
            g_r = grad(fp.reference_gram_contract)
            torch.cuda.synchronize()
            torch.testing.assert_close(g_k, g_r, **GRAD_TOL)
            e_bwd = max_err(g_k, g_r)
            rec["fwd"]["max_abs_err"] = max(rec["fwd"]["max_abs_err"], e_fwd)
            rec["bwd"]["max_abs_err"] = max(rec["bwd"]["max_abs_err"], e_bwd)
            kind = "se+p2" if use_poly else "se"
            if M != M_FLAGSHIP:
                print(f"  {kind:5s} P={P:3d} M={M}: K1 err {e_fwd:.3e} | K2 err {e_bwd:.3e}",
                      flush=True)
                continue

            xs_r = args[5].clone().requires_grad_(True)
            twin_args = list(args)
            twin_args[5] = xs_r

            def twin_bwd():
                out = fp.reference_gram_contract(*twin_args, use_poly)
                return torch.autograd.grad(out, xs_r, (wk, wq))

            t = dict(
                fwd=cuda_ms(lambda: fp.fused_gram_contract(*args, use_poly)),
                fwd_plain=cuda_ms(lambda: fp.reference_gram_contract(*args, use_poly)),
                bwd=cuda_ms(lambda: fp.fused_gram_contract_bwd_xstar(*args, wk, wq, use_poly)),
                bwd_plain=cuda_ms(twin_bwd),
            )
            print(f"  {kind:5s} P={P:3d} M={M}: K1 err {e_fwd:.3e} "
                  f"{t['fwd']:.4f} ms (twin {t['fwd_plain']:.4f} ms) | K2 err {e_bwd:.3e} "
                  f"{t['bwd']:.4f} ms (twin {t['bwd_plain']:.4f} ms)", flush=True)
            if use_poly and P == 400:  # the flagship shapes
                rec["fwd"].update(ms=t["fwd"], plain_ms=t["fwd_plain"])
                rec["bwd"].update(ms=t["bwd"], plain_ms=t["bwd_plain"])
    return rec


def check_real_posterior(gp, gp_params, post, gp_x, dev):
    """Predict through K1 on the fitted flagship posterior at P=400.

    The posterior algebra cancels heavily (|alpha| >> |mean|), so two fp32
    evaluations that sum in different orders differ far more than at the
    synthetic inputs of phase 2.  Both fp32 paths, kernel and plain, are
    held against a float64 evaluation of the same predict; the kernel must
    be no less accurate than the plain path (within 4x, plus 1e-6).
    """
    from mcpilco_tpu_torch.models.gp import tree_map

    rng = np.random.default_rng(0)
    xs = torch.as_tensor(gp_x[rng.integers(0, len(gp_x), 400)], device=dev)
    to64 = lambda tree: tree_map(torch.Tensor.double, tree)
    with torch.no_grad():
        m_k, v_k = gp._predict_fused(gp_params, post, xs)
        m_p, v_p = gp._predict_plain(gp_params, post, xs)
        m_64, v_64 = gp._predict_plain(to64(gp_params), to64(post), xs.double())
    torch.cuda.synchronize()
    errs = {name: (max_err(m.double(), m_64), max_err(v.double(), v_64))
            for name, (m, v) in (("kernel", (m_k, v_k)), ("plain", (m_p, v_p)))}
    print(f"  fitted posterior M={post.x_tr.shape[0]}, P=400, max |mean| "
          f"{float(m_64.abs().max()):.3e}, max var {float(v_64.max()):.3e}; against float64: "
          f"kernel mean err {errs['kernel'][0]:.3e} var err {errs['kernel'][1]:.3e} | "
          f"plain mean err {errs['plain'][0]:.3e} var err {errs['plain'][1]:.3e}", flush=True)
    for i, what in enumerate(("mean", "var")):
        if errs["kernel"][i] > 4 * errs["plain"][i] + 1e-6:
            raise RuntimeError(f"K1 {what} on the fitted posterior is less accurate than the "
                               f"plain path: {errs}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check has no CPU path",
              file=sys.stderr)
        return 1
    from mcpilco_tpu_torch import disable_tf32
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.ops import fused_predict as fp
    from mcpilco_tpu_torch.scenarios import cartpole as scen
    from mcpilco_tpu_torch.utils import prng

    dev = torch.device("cuda", 0)
    disable_tf32()
    card_facts()

    t0 = time.perf_counter()
    path, log = fp.build()
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower() or "Compiling" in line:
            print("  " + line.strip(), flush=True)
    phase(f"1 build ({path.name})", t0)

    t0 = time.perf_counter()
    rec = check_kernels(fp, dev)
    phase("2 kernels against the twin", t0)

    t0 = time.perf_counter()
    cfg = scen.CartpoleConfig(seed=1)
    agent, _ = scen.build(cfg, dev)
    for i in range(6):
        agent.collect(cfg.T_exploration, trial_index=i, exploration=True)
    t_fit = time.perf_counter()
    info = agent.fit_model(ModelFitOptions(num_epochs=1501))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    M = agent.posterior.x_tr.shape[0]
    print(f"  N={info['num_samples']} M={M} sod={info['sod_points']} "
          f"mll {info['mll_first']:.1f} -> {info['mll_last']:.1f}; GP fit + SOD + posterior "
          f"{fit_s:.2f} s; one-step MSE {agent.one_step_mse()}", flush=True)
    check_real_posterior(agent.gp, agent.gp_params, agent.posterior, agent.gp_x, dev)
    fp.launches.update(fwd=0, bwd=0)
    opt = agent.optimizer
    res = opt.optimize(prng.root_key(7), agent.policy_params, agent.gp_params,
                       agent.posterior, num_opt_steps=5, lr0=0.01, p_dropout0=0.25)
    torch.cuda.synchronize()
    t_opt = time.perf_counter()
    res = opt.optimize(prng.fold(prng.root_key(7), 1), agent.policy_params, agent.gp_params,
                       agent.posterior, num_opt_steps=30, lr0=0.01, p_dropout0=0.25)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t_opt
    costs = res.cost_history[: res.steps_done].numpy()
    if res.steps_done != 30 or not np.all(np.isfinite(costs)):
        raise RuntimeError(f"flagship step: {res.steps_done} steps, costs {costs}")
    if min(fp.launches.values()) == 0:
        raise RuntimeError(f"flagship step did not run both kernels: {fp.launches}")
    print(f"  {res.steps_done} steps: {1e3 * opt_s / res.steps_done:.2f} ms/step, "
          f"cost {costs[0]:.3f} -> {costs[-1]:.3f}, "
          f"launches {dict(fp.launches)}", flush=True)
    phase("3 flagship policy-optimization step", t0)

    t0 = time.perf_counter()
    agent, kwargs = scen.build(scen.CartpoleConfig(seed=1, num_trials=2, opt_steps=(100, 100)), dev)
    fp.launches.update(fwd=0, bwd=0)
    logs = agent.reinforce(**kwargs)
    torch.cuda.synchronize()
    main_launches = dict(fp.launches)
    for i, lg in enumerate(logs):
        c = lg.cost_history
        if lg.steps_done == 0 or not np.all(np.isfinite(c)):
            raise RuntimeError(f"trial {i}: {lg.steps_done} steps, costs {c}")
    if min(main_launches.values()) == 0:
        raise RuntimeError(f"the main path did not run both kernels: {main_launches}")
    print(f"  launches in reinforce: {main_launches}", flush=True)
    phase("4 main path: build + reinforce (2 trials)", t0)

    src = "mcpilco_tpu_torch/csrc/fused_predict.cu"
    kernels = [
        dict(name="fused_gram_contract (K1)", route="cuda", source=src,
             replaces="mcpilco_tpu/ops/fused_predict.py:225", launches=main_launches["fwd"],
             **rec["fwd"]),
        dict(name="fused_gram_contract_bwd_xstar (K2)", route="cuda", source=src,
             replaces="mcpilco_tpu/ops/fused_predict.py:271", launches=main_launches["bwd"],
             **rec["bwd"]),
    ]
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise RuntimeError("kernel timing missing")
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
