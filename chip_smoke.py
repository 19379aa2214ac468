#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mcpilco_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line with its time; any failure exits non-zero):

1. build the fused GP-predict kernels K1/K2 from ``csrc/`` with nvcc;
2. hold K1 and x*'s gradient through K2 against the plain PyTorch twin at
   G=2, D=6, M=384 and P in {400, 37} (and at M=100, P=37, a ragged edge),
   for 'se' and 'se+p2', and at the 4PMS shapes ('se', M=448, P in
   {400, 37}); time kernel against twin at M=384 and M=448; time the
   step's own predict, ``MultiGP._predict_plain`` against
   ``MultiGP._predict_fused``, forward and forward + x* backward, at the
   flagship and the 4PMS shapes;
3. the flagship policy-optimization step: 6 exploration trials (N~360),
   a 1501-epoch GP fit with the SOD posterior, 30 optimizer steps;
4. the flagship main path through the user's entry points:
   ``cartpole.build`` then ``reinforce`` for 2 trials at full width, and
   the multi-init variant for 1 trial, with the kernel launch counts of
   those runs;
5. the 4PMS policy-optimization step: 5 sinusoid-exploration trials
   through the PMS plant with offline filtering (N=440, M=448), a
   1501-epoch exact GP fit, the fitted 'se' posterior through K1 against
   float64, 30 optimizer steps at P=400 and horizon 90;
6. the 4PMS main path: ``cartpole_pms.build`` then ``reinforce`` for 2
   trials at full width, with its launch counts.

There is no CPU path: without a CUDA device the script exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their launches (phases 4 and 6), errors and times.
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
G, D, M_FLAGSHIP, M_PMS = 2, 6, 384, 448


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
    # M=100 exercises the ragged edge of K2's F tiles (the main path's
    # buckets are multiples of 64); it is checked, not timed.  M=448 is the
    # 4PMS path's last bucket ('se' only, no SOD)
    cases = [(False, P, M) for P, M in ((400, M_FLAGSHIP), (37, M_FLAGSHIP), (37, 100),
                                         (400, M_PMS), (37, M_PMS))]
    cases += [(True, P, M) for P, M in ((400, M_FLAGSHIP), (37, M_FLAGSHIP), (37, 100))]
    for use_poly, P, M in cases:
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
        if M not in (M_FLAGSHIP, M_PMS):
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


def time_predicts(dev):
    """The step's own predict per rollout step, plain ops against kernels.

    ``MultiGP._predict_plain`` (the batched PyTorch ops the CPU runs) and
    ``MultiGP._predict_fused`` (K1, and K2 in the backward), forward alone
    and forward + the x* backward that BPTT takes, at the flagship shapes
    ('se+p2', P=400, M=384) and the 4PMS shapes ('se', P=400, M=448).
    """
    from mcpilco_tpu_torch.models import kernels as K
    from mcpilco_tpu_torch.models.gp import MultiGP, Posterior

    dims = tuple(range(D))
    for label, kern, M in (("flagship se+p2", K.se_plus_volterra(dims, 2), M_FLAGSHIP),
                           ("4PMS se", K.SEArd(dims), M_PMS)):
        gp = MultiGP(kernel=kern, num_heads=G)
        params = gp.init_params(device=dev)
        args = kernel_inputs(400, M, seed=M, dev=dev)
        x_star = args[5]
        post = Posterior(x_tr=args[6], mask=args[9], alpha=args[7], var_factor=args[8],
                         norm=torch.ones(G, device=dev))
        wk = torch.linspace(0.5, 1.5, G * 400, device=dev).reshape(G, 400)
        wq = torch.linspace(-1.0, 1.0, G * 400, device=dev).reshape(G, 400)

        def fwd_bwd(predict):
            xs = x_star.clone().requires_grad_(True)
            mean, var = predict(params, post, xs)
            return torch.autograd.grad(torch.sum(wk * mean) + torch.sum(wq * var), xs)

        t = {name: (cuda_ms(lambda: fn(params, post, x_star)), cuda_ms(lambda: fwd_bwd(fn)))
             for name, fn in (("plain", gp._predict_plain), ("fused", gp._predict_fused))}
        print(f"  predict {label} P=400 M={M}: _predict_plain fwd {t['plain'][0]:.4f} ms, "
              f"fwd+bwd {t['plain'][1]:.4f} ms | _predict_fused fwd {t['fused'][0]:.4f} ms, "
              f"fwd+bwd {t['fused'][1]:.4f} ms", flush=True)


def check_real_posterior(gp, gp_params, post, gp_x, dev):
    """Predict through K1 on a fitted posterior at P=400.

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


def policy_step(agent, num_trials, T, fp, dev, expect_m=None):
    """Collect ``num_trials`` exploration trials, fit the GP for 1501 epochs,
    hold K1 on the fitted posterior against float64, then time 30 optimizer
    steps at full width after 5 warm-up steps."""
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.utils import prng

    t_plant = time.perf_counter()
    for i in range(num_trials):
        agent.collect(T, trial_index=i, exploration=True)
    plant_s = time.perf_counter() - t_plant
    t_fit = time.perf_counter()
    info = agent.fit_model(ModelFitOptions(num_epochs=1501))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    M = agent.posterior.x_tr.shape[0]
    print(f"  {num_trials} trials {plant_s:.2f} s; N={info['num_samples']} M={M} "
          f"sod={info.get('sod_points', 'none')} mll {info['mll_first']:.1f} -> "
          f"{info['mll_last']:.1f}; GP fit + posterior {fit_s:.2f} s; one-step MSE "
          f"{agent.one_step_mse()}", flush=True)
    if expect_m is not None and M != expect_m:
        raise RuntimeError(f"expected the M={expect_m} bucket, got M={M}")
    check_real_posterior(agent.gp, agent.gp_params, agent.posterior, agent.gp_x, dev)
    fp.launches.update(fwd=0, bwd=0)
    opt = agent.optimizer
    opt.optimize(prng.root_key(7), agent.policy_params, agent.gp_params, agent.posterior,
                 num_opt_steps=5, lr0=0.01, p_dropout0=0.25)
    torch.cuda.synchronize()
    t_opt = time.perf_counter()
    res = opt.optimize(prng.fold(prng.root_key(7), 1), agent.policy_params, agent.gp_params,
                       agent.posterior, num_opt_steps=30, lr0=0.01, p_dropout0=0.25)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t_opt
    costs = res.cost_history[: res.steps_done].numpy()
    if res.steps_done != 30 or not np.all(np.isfinite(costs)):
        raise RuntimeError(f"policy step: {res.steps_done} steps, costs {costs}")
    if min(fp.launches.values()) == 0:
        raise RuntimeError(f"the policy step did not run both kernels: {fp.launches}")
    print(f"  {res.steps_done} steps at P={opt.num_particles}, horizon {opt.horizon}: "
          f"{1e3 * opt_s / res.steps_done:.2f} ms/step, cost {costs[0]:.3f} -> "
          f"{costs[-1]:.3f}, launches {dict(fp.launches)}", flush=True)


def main_path(built, fp):
    """``reinforce`` of a freshly built agent; returns its kernel launches."""
    agent, kwargs = built
    fp.launches.update(fwd=0, bwd=0)
    logs = agent.reinforce(**kwargs)
    torch.cuda.synchronize()
    launches = dict(fp.launches)
    for i, lg in enumerate(logs):
        c = lg.cost_history
        if lg.steps_done == 0 or not np.all(np.isfinite(c)):
            raise RuntimeError(f"trial {i}: {lg.steps_done} steps, costs {c}")
    if min(launches.values()) == 0:
        raise RuntimeError(f"the main path did not run both kernels: {launches}")
    print(f"  launches in reinforce: {launches}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check has no CPU path",
              file=sys.stderr)
        return 1
    from mcpilco_tpu_torch import disable_tf32
    from mcpilco_tpu_torch.ops import fused_predict as fp
    from mcpilco_tpu_torch.scenarios import cartpole, cartpole_pms

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
    time_predicts(dev)
    phase("2 kernels against the twin", t0)

    t0 = time.perf_counter()
    cfg = cartpole.CartpoleConfig(seed=1)
    policy_step(cartpole.build(cfg, dev)[0], 6, cfg.T_exploration, fp, dev)
    phase("3 flagship policy-optimization step", t0)

    t0 = time.perf_counter()
    cfg = cartpole.CartpoleConfig(seed=1, num_trials=2, opt_steps=(50, 50))
    flagship_launches = main_path(cartpole.build(cfg, dev), fp)
    cfg = cartpole.CartpoleConfig(seed=1, multi_init=True, num_trials=1, opt_steps=(30,))
    multi_launches = main_path(cartpole.build(cfg, dev), fp)
    phase("4 flagship main path: build + reinforce (2 trials; multi-init 1 trial)", t0)

    t0 = time.perf_counter()
    cfg = cartpole_pms.CartpolePMSConfig(seed=1)
    policy_step(cartpole_pms.build(cfg, dev)[0], 5, cfg.T_exploration, fp, dev, expect_m=M_PMS)
    phase("5 4PMS policy-optimization step", t0)

    t0 = time.perf_counter()
    cfg = cartpole_pms.CartpolePMSConfig(seed=1, num_trials=2, opt_steps=(100, 100))
    pms_launches = main_path(cartpole_pms.build(cfg, dev), fp)
    phase("6 4PMS main path: build + reinforce (2 trials)", t0)

    main_launches = {k: flagship_launches[k] + multi_launches[k] + pms_launches[k]
                     for k in flagship_launches}
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
