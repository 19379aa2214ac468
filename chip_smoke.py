#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mcpilco_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line with its time; any failure exits non-zero):

1. build the fused GP-predict kernels K1/K2 from ``csrc/`` with nvcc;
2. hold K1 (kalpha, quad and the kF it saves for K2) and K2 against
   their plain PyTorch versions, and x*'s gradient through ``GramContract``
   against autograd through the plain K1, over P in {1, 37, 400}, M in
   {37, 100, 384, 448, 1024} and both modes ('se', 'se+p2'); check that two
   calls give bitwise-equal outputs; time kernel against plain version at
   the flagship ('se+p2', M=384), 'se' M=384 and 4PMS ('se', M=448) shapes
   at P=400, as back-to-back CUDA-event times (host-bound) and as device
   time (torch.profiler kernel records); time the step's own predict,
   ``MultiGP._predict_plain`` against ``MultiGP._predict_fused``, forward
   and forward + x* backward, the same two ways; print the blocks per
   launch at P=400;
3. the flagship policy-optimization step: 6 exploration trials (N~360),
   a 1501-epoch GP fit with the SOD posterior, 30 optimizer steps, then
   the learning-curve check: 10 steps from one key through the kernels and
   through ``MultiGP._predict_plain``, both cost trajectories printed;
4. the flagship main path through the user's entry points:
   ``cartpole.build`` then ``reinforce`` for 2 trials at full width, and
   the multi-init variant for 1 trial, with the kernel launch counts of
   those runs;
5. the 4PMS policy-optimization step: 5 sinusoid-exploration trials
   through the PMS plant with offline filtering (N=440, M=448), a
   1501-epoch exact GP fit, the fitted 'se' posterior through K1 against
   float64, 30 optimizer steps at P=400 and horizon 90, and the
   learning-curve check;
6. the 4PMS main path: ``cartpole_pms.build`` then ``reinforce`` for 2
   trials at full width, with its launch counts.

There is no CPU path: without a CUDA device the script exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their launches (phases 4 and 6), errors and device times at
the flagship shapes.
"""

import contextlib
import json
import math
import subprocess
import sys
import time

from unittest import mock

import numpy as np
import torch

FWD_TOL = dict(rtol=2e-5, atol=1e-5)  # tests/test_fused_predict.py:32
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_fused_predict.py:65
G, D, M_FLAGSHIP, M_PMS = 2, 6, 384, 448
SWEEP_P, SWEEP_M = (1, 37, 400), (37, 100, 384, 448, 1024)


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
    """Mean time of ``fn`` over ``iters`` back-to-back calls, between two
    CUDA events: for calls of a few tens of microseconds it is bound by the
    host's launch rate, not by the device."""
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


def device_us(fn, iters=20, warmup=3):
    """Device time per call of ``fn`` in microseconds, by kernel name, from
    torch.profiler's kernel records over ``iters`` calls: the host's launch
    gaps are not in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / iters
    if not per:
        raise RuntimeError("torch.profiler recorded no kernel on the card")
    return per


def named_us(per, name):
    return sum(t for k, t in per.items() if name in k)


def max_err(a, b):
    return float(torch.max(torch.abs(a - b)))


def cotangents(P, dev):
    wk = torch.linspace(0.5, 1.5, G * P, device=dev).reshape(G, P)
    wq = torch.linspace(-1.0, 1.0, G * P, device=dev).reshape(G, P)
    return wk, wq


def check_case(fp, use_poly, P, M, dev):
    """K1 and K2 against their plain versions at one shape, x*'s gradient
    through GramContract against autograd through the plain K1, and two
    calls bitwise equal.  Returns the max errors (K1, K2)."""
    args = kernel_inputs(P, M, seed=P + M + 10 * use_poly, dev=dev)
    wk, wq = cotangents(P, dev)
    out = fp.fused_gram_contract(*args, use_poly, return_kf=True)
    ref = fp.reference_gram_contract(*args, use_poly, return_kf=True)
    dx = fp.fused_gram_contract_bwd_xstar(*args, out[2], wk, wq, use_poly)
    dx_r = fp.reference_gram_contract_bwd_xstar(*args, ref[2], wk, wq, use_poly)
    again = fp.fused_gram_contract(*args, use_poly, return_kf=True)
    dx_again = fp.fused_gram_contract_bwd_xstar(*args, again[2], wk, wq, use_poly)

    def grad(fn):
        xs = args[5].clone().requires_grad_(True)
        ka_, qd_ = fn(*args[:5], xs, *args[6:], use_poly)
        return torch.autograd.grad(torch.sum(wk * ka_) + torch.sum(wq * qd_), xs)[0]

    g_k, g_r = grad(fp.gram_contract), grad(fp.reference_gram_contract)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        torch.testing.assert_close(got, want, **FWD_TOL)
    torch.testing.assert_close(dx, dx_r, **GRAD_TOL)
    torch.testing.assert_close(g_k, g_r, **GRAD_TOL)
    if not all(torch.equal(a, b) for a, b in zip((*out, dx), (*again, dx_again))):
        raise RuntimeError(f"P={P} M={M}: two calls on the same inputs differ")
    e_fwd = max(max_err(a, b) for a, b in zip(out, ref))
    e_bwd = max(max_err(dx, dx_r), max_err(g_k, g_r))
    kind = "se+p2" if use_poly else "se"
    print(f"  {kind:5s} P={P:3d} M={M:4d}: K1 err {e_fwd:.3e} | K2 err {e_bwd:.3e} "
          f"(plain K2 {max_err(dx, dx_r):.3e}, autograd {max_err(g_k, g_r):.3e}) | "
          f"bitwise equal across calls", flush=True)
    return e_fwd, e_bwd


def time_kernels(fp, use_poly, M, dev):
    """K1 (as the main path calls it, saving kF) and K2 against their plain
    versions at P=400: CUDA-event and device times, in ms."""
    P = 400
    args = kernel_inputs(P, M, seed=M + 10 * use_poly, dev=dev)
    wk, wq = cotangents(P, dev)
    kf = fp.fused_gram_contract(*args, use_poly, return_kf=True)[2]
    kf_r = fp.reference_gram_contract(*args, use_poly, return_kf=True)[2]
    fns = dict(
        k1=lambda: fp.fused_gram_contract(*args, use_poly, return_kf=True),
        k1_plain=lambda: fp.reference_gram_contract(*args, use_poly),
        k2=lambda: fp.fused_gram_contract_bwd_xstar(*args, kf, wk, wq, use_poly),
        k2_plain=lambda: fp.reference_gram_contract_bwd_xstar(*args, kf_r, wk, wq, use_poly),
    )
    events = {k: cuda_ms(fn) for k, fn in fns.items()}
    per = {k: device_us(fn) for k, fn in fns.items()}
    dev_ms = {k: 1e-3 * sum(p.values()) for k, p in per.items()}
    dev_ms["k1_kernel"] = 1e-3 * named_us(per["k1"], "k1_forward")
    dev_ms["k2_kernel"] = 1e-3 * named_us(per["k2"], "k2_backward_xstar")
    kind = "se+p2" if use_poly else "se"
    print(f"  time {kind:5s} P={P} M={M}, device ms: K1 kernel {dev_ms['k1_kernel']:.4f} "
          f"(call {dev_ms['k1']:.4f}) plain {dev_ms['k1_plain']:.4f} | K2 kernel "
          f"{dev_ms['k2_kernel']:.4f} (call {dev_ms['k2']:.4f}) plain {dev_ms['k2_plain']:.4f}; "
          f"back to back (CUDA events): K1 {events['k1']:.4f} plain {events['k1_plain']:.4f} | "
          f"K2 {events['k2']:.4f} plain {events['k2_plain']:.4f}", flush=True)
    return dev_ms


def check_kernels(fp, dev):
    """Phase 2: the sweep, the timings, and the launch facts; returns
    per-kernel records for the kernels line."""
    rec = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    for use_poly in (False, True):
        for P in SWEEP_P:
            for M in SWEEP_M:
                e_fwd, e_bwd = check_case(fp, use_poly, P, M, dev)
                rec["fwd"]["max_abs_err"] = max(rec["fwd"]["max_abs_err"], e_fwd)
                rec["bwd"]["max_abs_err"] = max(rec["bwd"]["max_abs_err"], e_bwd)
    for use_poly, M in ((True, M_FLAGSHIP), (False, M_FLAGSHIP), (False, M_PMS)):
        t = time_kernels(fp, use_poly, M, dev)
        if use_poly:  # the flagship shapes
            rec["fwd"].update(ms=t["k1_kernel"], plain_ms=t["k1_plain"])
            rec["bwd"].update(ms=t["k2_kernel"], plain_ms=t["k2_plain"])
    for M in (M_FLAGSHIP, M_PMS):
        k1, k2 = fp.launch_blocks(G, 400, M)
        print(f"  blocks per launch at P=400 M={M}: K1 {k1}, K2 {k2} (132 SMs)", flush=True)
    return rec


def time_predicts(dev):
    """The step's own predict per rollout step, plain ops against kernels.

    ``MultiGP._predict_plain`` (the batched PyTorch ops the CPU runs) and
    ``MultiGP._predict_fused`` (K1, and K2 in the backward), forward alone
    and forward + the x* backward that BPTT takes, at the flagship shapes
    ('se+p2', P=400, M=384) and the 4PMS shapes ('se', P=400, M=448): back
    to back between CUDA events, and as device time.
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
        wk, wq = cotangents(400, dev)

        def fwd_bwd(predict):
            xs = x_star.clone().requires_grad_(True)
            mean, var = predict(params, post, xs)
            return torch.autograd.grad(torch.sum(wk * mean) + torch.sum(wq * var), xs)

        t = {name: (cuda_ms(lambda: fn(params, post, x_star)), cuda_ms(lambda: fwd_bwd(fn)))
             for name, fn in (("plain", gp._predict_plain), ("fused", gp._predict_fused))}
        print(f"  predict {label} P=400 M={M}: _predict_plain fwd {t['plain'][0]:.4f} ms, "
              f"fwd+bwd {t['plain'][1]:.4f} ms | _predict_fused fwd {t['fused'][0]:.4f} ms, "
              f"fwd+bwd {t['fused'][1]:.4f} ms (back to back, CUDA events)", flush=True)
        per = {name: device_us(lambda: fwd_bwd(fn))
               for name, fn in (("plain", gp._predict_plain), ("fused", gp._predict_fused))}
        print(f"  predict {label} P=400 M={M}, device ms per fwd+bwd: _predict_plain "
              f"{1e-3 * sum(per['plain'].values()):.4f} | _predict_fused "
              f"{1e-3 * sum(per['fused'].values()):.4f} (K1 "
              f"{1e-3 * named_us(per['fused'], 'k1_forward'):.4f}, K2 "
              f"{1e-3 * named_us(per['fused'], 'k2_backward_xstar'):.4f})", flush=True)


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
    learning_curve(agent, fp)


def learning_curve(agent, fp, steps=10):
    """The gate for a kernel change: ``steps`` optimizer steps from one key,
    once through the kernels and once through ``MultiGP._predict_plain``;
    prints both cost trajectories and the gap of their last costs."""
    from mcpilco_tpu_torch.models.gp import MultiGP
    from mcpilco_tpu_torch.utils import prng

    curves = {}
    for name in ("kernel", "plain"):
        with (mock.patch.object(MultiGP, "predict", MultiGP._predict_plain) if name == "plain"
              else contextlib.nullcontext()):
            fp.launches.update(fwd=0, bwd=0)
            res = agent.optimizer.optimize(prng.fold(prng.root_key(7), 2), agent.policy_params,
                                           agent.gp_params, agent.posterior,
                                           num_opt_steps=steps, lr0=0.01, p_dropout0=0.25)
            torch.cuda.synchronize()
        costs = res.cost_history[: res.steps_done].numpy()
        if res.steps_done != steps or not np.all(np.isfinite(costs)):
            raise RuntimeError(f"learning curve ({name}): {res.steps_done} steps, costs {costs}")
        if (min(fp.launches.values()) > 0) != (name == "kernel"):
            raise RuntimeError(f"learning curve ({name}): kernel launches {fp.launches}")
        curves[name] = costs
    gap = abs(curves["kernel"][-1] - curves["plain"][-1]) / abs(curves["plain"][-1])
    for name, c in curves.items():
        print(f"  learning curve, {steps} steps from one key, {name:6s}: "
              f"{' '.join(f'{v:.4f}' for v in c)}", flush=True)
    print(f"  learning curve: last costs {curves['kernel'][-1]:.4f} (kernel) against "
          f"{curves['plain'][-1]:.4f} (plain), gap {100 * gap:.3f}%", flush=True)


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
        if any(w in line for w in ("registers", "spill", "Compiling")) or "error" in line.lower():
            print("  " + line.strip(), flush=True)
    phase(f"1 build ({path.name})", t0)

    t0 = time.perf_counter()
    rec = check_kernels(fp, dev)
    time_predicts(dev)
    phase("2 kernels against their plain versions", t0)

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
