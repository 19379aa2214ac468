#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mcpilco_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line with its time; any failure exits non-zero).
Every optimization runs as the port's users run it: on the card
``PolicyOptimizer`` captures its iteration as a CUDA graph after one
uncaptured iteration and replays it, K iterations per host read; phase 15
holds that against one read per iteration (``chunk=1``) and, on the
flagship, against the uncaptured body (``graph=False``).


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
   a 1501-epoch GP fit with the SOD posterior, 10 optimizer steps, then
   the learning-curve check: 10 steps from one key through the kernels and
   through ``MultiGP._predict_plain``, both cost trajectories printed;
4. the multi-init main path: ``cartpole.build`` then ``reinforce`` for 1
   trial of 3 steps at full width (a 500-epoch fit), with its kernel
   launch counts (the flagship's own build + reinforce is phase 12 (a));
5. the 4PMS policy-optimization step: 5 sinusoid-exploration trials
   through the PMS plant with offline filtering (N=440, M=448), a
   1501-epoch exact GP fit, the fitted 'se' posterior through K1 against
   float64, 10 optimizer steps at P=400 and horizon 90, and the
   learning-curve check;
6. the 4PMS main path: ``cartpole_pms.build`` then ``reinforce`` for 1
   trial of 3 steps at full width (a 500-epoch fit), with its launch
   counts;
7. the seed farm at full width: ``SeedFarm`` over 4 flagship seeds (P=400,
   horizon 60, SE+P(2), SOD, 500-epoch fits), 1 exploration and 1 trial
   of 10 steps, K1/K2 launched with 4 lanes; its ``improve_policy`` again
   with ``chunk_steps_override=4`` (the 9 steps after the uncaptured first
   iteration in chunks of 4, 4 and 1) against the default chunks: costs,
   steps and params bitwise equal, host reads 4 against 2, a
   ``progress_cb`` tick per read, K1/K2 at L=4; then the farm's optimizer
   step profiled beside one seed's (host ms/step over 2 steps, device
   busy, device events per step, idle share), and one seed's 10-step cost
   curve farmed against the same seed trained alone (within 0.1% relative);
8. restart lanes: a 1-trial 4PMS ``reinforce`` of 3 steps (a 500-epoch
   fit) with ``num_restarts=2``, with each lane's cost and the winner;
9. the Furuta policy-optimization step: 2 exploration trials of the
   QUBE-like plant (N=300, M=320, exact GP), a 500-epoch fit of the
   semiparametric Sum(SE, Linear) model (the SE model below: 1501), its
   posterior against float64 on the plain path, 10 optimizer steps at P=400
   and horizon 150 (profiled in phase 15 with ``--full-profile``); then
   the same on the same two trials with ``semiparametric=False`` (SE over 12
   dims, K1/K2 in their wide path), 10 steps timed (with ``--full-profile``
   2, as the host window of the step profile: host ms/step, then device
   busy, device events per step and idle share over 2 profiled steps), the
   fitted posterior through K1 against float64 and the learning-curve check;
10. the Furuta main path: ``furuta.build`` then ``reinforce`` for 1 trial
    of 3 steps (300-epoch fit; no kernel structure: 0 launches), and the
    ``semiparametric=False`` variant the same (both kernels);
11. SOR: the flagship cart-pole ``reinforce`` for 1 trial of 10 steps (a
    500-epoch fit) with
    the SOD posterior replaced by the Subset-of-Regressors approximation
    (relative threshold 0.5, 200 epochs of SOR-MLL refinement with trained
    inducing inputs), with the inducing points, the SOR MLL and ms/step;
12. the user's entry points at full flagship width (5 steps per trial,
    300-epoch fits), checkpoints under ``results_tmp/``: (a) ``build`` +
    ``reinforce`` of 2 of the config's 3 trials, a run interrupted after
    trial 1, with the reserved device memory after each trial (no growth:
    each trial's graph and its memory pool are freed), each stage
    checkpoint's size, save and load seconds, and
    the restored arrays bitwise equal to the run's and the rebuilt
    posterior's K1 predictions within FWD_TOL of the run's; (b) the resume
    through ``scripts.train_cartpole.run(cfg, auto_resume=True)``: 2 trials
    resumed, trial 2 trained, its cost gap to the unbroken run's trial 2;
    (c) ``scripts.apply_policy`` on ``complete_trial1``, 5 plant runs and 400
    particles x 60 steps on the model; (d) ``scripts.repeat --farm`` over 2
    seeds of 1 trial; (e) ``scripts.repeat --no-farm --jobs 2 --trials 1
    --extra-flag=--opt-steps=5 --extra-flag=--gp-epochs=300`` over 2 flagship
    seeds at full width (depth cut only), each a subprocess of
    ``train_cartpole`` on the card with its ``stdout.log``; (f) after
    phase 14, ``scripts.summarize_results --json`` over the summaries of
    (d), (e) and phase 14 (d): their three rows beside the JAX package's
    flagship record;
13. UR5 from the recorded trials (``mcpilco_tpu_torch/envs/assets/
    ur5_pd_trials.npz``; the card's machine has no ``mujoco``, so the
    MuJoCo plant is built and never rolled out): ``ur5.build`` at full width
    (400 basis functions, P=200, horizon 200, 6 heads, D=24, remat), the two
    trials in through ``add_external_trial``, a 1001-epoch fit (N=400,
    M=448); the default Sum(SE, MPK1) model on the plain predict: its
    posterior against float64, one rollout + backward with remat on and off
    (gradients bitwise, peak memory; its step profile: phase 15 with
    ``--full-profile``); then
    ``poly_degree=2`` on the same trials (K1/K2 in their wide
    path at D=24 G=6 P=200 M=448) with the cost curriculum (the plateau
    rescue's configuration: the fixed cost starts this seed on its
    saturated plateau): posterior through K1 against float64, 3 steps timed
    (with ``--full-profile`` the step profile), K1/K2 device time on the
    fitted posterior; then the HIL
    main path: ``improve_policy`` of 3 steps (the kernel side of the
    learning curve against ``_predict_plain``), ``export_policy_csv`` and a
    checkpoint round trip restored bitwise;
14. the seed farm over the other scenarios at full width, depth cut: (a)
    4PMS over 4 seeds (P=400, horizon 90, exact 'se' GP, BPTT clip 0.2,
    300-epoch fits, 1 trial of 5 steps), K1/K2 with 4 lanes, the device
    offline estimator against the host path on the farm's exploration
    trials, the step profile beside one seed's and beside one seed as a
    lane axis of size 1 (equal device events), one seed's 5-step curve
    farmed against alone (within 5e-3 relative); (b) Furuta's shipped
    semiparametric model over 4 seeds (1 trial of 3 steps, no kernel
    launch), its curve (with ``--full-profile`` its step profile beside one
    seed's); (c) the host-plant collection
    (``SeedFarm._collect_host``) with the flagship's ODE plant behind a
    host plant's ``rollout()`` (the card's machine has no ``mujoco``), 2
    seeds of 3 steps, training pairs against the device plant's farm within
    1e-6; (d) ``scripts.repeat --scenario cartpole_pms --farm`` over 2
    seeds; (e) the 4PMS farm's posteriors under the legacy variance
    operator: ``MultiGP.predict`` launches no kernel and agrees with the
    factor form through K1 at FWD_TOL;
15. the loop: on five paths (the flagship of phase 3, 4PMS of phase 5, the
    flagship farm at S=4 of phase 7, Furuta semiparametric of phase 9, UR5
    with remat of phase 13, each fitted there, or here with 500 epochs when
    its phase did not run), the graphed optimizer step at its default
    iterations per host read against one read per iteration (``chunk=1``),
    and on the flagship against the uncaptured body too; the flagship's
    chunked and chunk=1 steps (with ``--full-profile`` every mode of every
    path) profiled: host ms/step in turns, device busy, the device's idle
    time inside one replay, device events and host CUDA API calls per step,
    idle share, K1/K2 per step; on every path capture + instantiate seconds
    and a learning curve in each mode
    (10 steps; 3 for Furuta and UR5) with its host reads and the iterations
    run after the lanes stopped: the chunked curve and params bitwise those
    of chunk=1 (the uncaptured ones within two uncaptured runs' spread or
    1e-5 relative), events within 0.4%, K1/K2 counted alike; then the
    flagship made to exit at step 2 of a 10-step call (at most
    ``POLL_LAG`` - 1 iterations after the exit, results bitwise those of
    chunk=1) and its reserved memory over three graphed calls (no growth).
    One JSON line ``{"graph": ...}`` holds the rows;
16. the mesh (``parallel/mesh.py``): ``parallel.dryrun.worker`` on
    min(4, cards) NCCL ranks (1, 2 or 4), one process per card, at full
    flagship width: (a) the particle round (phase 3's dataset and fitted
    GP, 5 more GP epochs, 10 optimizer steps, P=400 over "p", the cost
    pieces and the gradient all-reduced inside each rank's graph), its step
    profiled per rank beside one card's (host ms/step, device busy, events,
    NCCL kernels and their device us per step); (b) phase 7's farm over the
    seed groups, with seed-steps/s over the cards against one card's; (c)
    the same farm on a 2D ("s", "p") mesh; (d) 4 restart lanes on an
    ("r", "p") mesh.  Each is held against the same run on one card in
    this process (the farms against phase 7's): bitwise where no particle
    shard is split (every check at world 1; the seed farm at any world),
    else at the JAX package's particle tolerances; every disagreement is
    printed before the phase fails.  With one card it says that the checks
    over 2-4 cards did not run.  One JSON line ``{"mesh": ...}``.

Phase 2 also holds K1/K2 in their wide path (input dims above 8: K1's
generation kernel ``k1_gen`` and GEMM, K2-wide) against their plain versions,
and ``k1_gen`` alone (``fused_gram_gen``) against ``reference_gram_gen``, at
the Furuta shapes ('se', D=12, G=2, P=400, M in {192, 960}) and the UR5
shape ('se+p2', D=24, G=6, P=200, M=448), with device times, bounds and the
blocks of ``wide_plan``; at its edges (``WIDE_EDGES``: D=10, 17, 32, P=1
and 37, M=37 and 1024) against a float64 evaluation of the plain versions
(``check_edge``); and ``MultiGP.predict`` on the card at the main
paths' widths (K1, its generation pass and K2 launched once each, against
``_predict_plain``).  It also
holds the lane-batched K1/K2 (L in {1, 4} at the flagship and
4PMS shapes, L=3 at M=37, whose lane strides are not 16-byte aligned, L=4
at the farms' M=128 in both modes, L=4 in the wide path at 'se' D=12
M=192, and P=800 for two folded restart lanes) against their
plain versions and, lane by lane, bitwise against the L=1 launch, with
device time per launch beside L x the L=1 time; and ``MultiGP.predict`` as
the restart fold and the farm's lane posteriors call it, lane by lane
against ``MultiGP._predict_plain``.

There is no CPU path: without a CUDA device the script exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their launches (phases 4, 6, 7, 8, 10, 11, 12, 13, 14 and
16, the last summed over its ranks; a graph's launches count once per
replay),
errors, device times at the flagship shapes and their bounds, and the same
per wide shape and for the L=4 lane shapes of the 4PMS farm and the wide
path (``by_shape``; the UR5 shape with its launches in phase 13 and its
device time on the fitted posterior, the 4PMS farm's with its launches per
optimizer step in phase 14).

    python3 chip_smoke.py --phases 2,9,10,14

runs phase 1 and only the listed phases (the kernels line needs all;
``--phases 15`` alone fits its five paths itself, ``--phases 16`` its
flagship and farm).

    python3 chip_smoke.py --full-profile

also profiles the steps that the default run only times or runs: phase 9's
Furuta SE step, phase 13's UR5 K1/K2 step, phase 14 (b)'s Furuta farm beside
one seed, and every mode of every path of phase 15 (the default profiles
the flagship's chunked and chunk=1 steps there); it adds ~4 minutes.

    python3 chip_smoke.py --kernel-ab PATH

builds the kernels of the checkout at PATH beside this checkout's and times
K1/K2 for PATH / this / this / PATH (shapes in order, then reversed) at the
flagship and 4PMS shapes (the flagship's also at P=1600 and 3200) and at
phase 2's wide shapes ('se' D=12 M=192 and 960, UR5's 'se+p2' D=24, 'se'
D=12 L=4 M=192): ``AB_WINDOWS`` profiled
windows per kernel and turn (device us per kernel, windows that lost
records refused), back-to-back CUDA-event times, the SM clock and power
beside each shape, K1 with the L2 flushed before each launch, the plain
versions once; it fails unless both builds' narrow outputs are bitwise
equal, and prints the largest difference between them at the wide shapes.
Both builds' ``ptxas`` reports; the rows also go to
``chiprun_out/kernel_ab.json``.

    python3 chip_smoke.py --farm-sweep 1,2,4,8

builds the kernels and profiles instead the farm's optimizer step at each
seed count S (6 exploration trials per seed, N=360, a 1501-epoch fit, the
SOD posterior in the M=384 bucket): host ms per step of all seeds, device
busy, device events per step and idle share.

    python3 chip_smoke.py --step-profile PATH

profiles the single-seed flagship optimizer step of the package in the
checkout at PATH (another commit unpacked with ``git archive``, to compare
two commits in turns in one call; PATH's package must have
``utils/profiling.py``) through its public entry points: 6
exploration trials, a 500-epoch fit, then host ms/step three times, device
busy and device events per step, and the events per step of each kernel.
"""

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

from unittest import mock

import numpy as np
import torch

# the kernels' tolerances (ops/fused_predict.py), set by main() once it has
# imported the package
FWD_TOL = GRAD_TOL = None
G, D, M_FLAGSHIP, M_PMS = 2, 6, 384, 448
SWEEP_P, SWEEP_M = (1, 37, 400), (37, 100, 384, 448, 1024)
# (use_poly, P, M, lane counts[, G, D]) of the lane-batched checks; M=37
# gives lane strides of F that are not a multiple of 16 bytes; P=800 is two
# restart lanes folded into one call (phase 8 and the 4PMS protocol), L=4 at
# M=128 the farms' launches (phase 7 'se+p2', phase 14's 4PMS farm 'se'),
# 'se' at D=12 M=192 the wide path with lanes (the Furuta farm with
# semiparametric=False)
M_SMALL = 128
LANE_CASES = ((True, 400, M_FLAGSHIP, (1, 4)), (False, 400, M_PMS, (1, 4)),
              (False, 37, 37, (3,)), (True, 37, 37, (3,)), (True, 400, M_SMALL, (4,)),
              (False, 400, M_SMALL, (1, 4)), (False, 800, M_SMALL, (1,)),
              (False, 800, M_PMS, (1,)), (False, 400, 192, (1, 4), 2, 12))
# the lane shapes whose device time, plain time and bound go into the
# kernels line's by_shape rows: the 4PMS farm's and the wide path's at L=4
LANE_ROWS = {(False, 400, M_SMALL, 4, 6), (False, 400, 192, 4, 12)}
FARM_SEEDS = 4
# --kernel-ab's shapes (use_poly, G, P, M, D, L): the flagship's and 4PMS's,
# the flagship's at bench_particle_scaling's P=1600 and 3200, phase 2's wide
# shapes and the wide path with lanes; profiled windows per kernel, shape
# and turn
AB_SHAPES = ((True, G, 400, M_FLAGSHIP, D, 1), (False, G, 400, M_PMS, D, 1),
             (True, G, 1600, M_FLAGSHIP, D, 1), (True, G, 3200, M_FLAGSHIP, D, 1),
             (False, 2, 400, 192, 12, 1), (False, 2, 400, 960, 12, 1),
             (True, 6, 200, 448, 24, 1), (False, 2, 400, 192, 12, 4))
AB_WINDOWS = 2
# the out-tag of phase 12's subprocess seeds
JOBS_TAG = "chip_smoke_jobs"
# phase 7's chunk_steps_override: the 9 steps after the uncaptured first
# iteration in chunks of 4, 4 and 1
FARM_CHUNK = 4
# the wide path's shapes: (use_poly, G, P, M, D); the Furuta SE posterior at
# its first and sixth trial, and UR5's SE+P(2); and, checked against float64
# (check_edge) but not timed, its edges: D % 4 != 0 (4-byte staging), ragged
# P and M (M % 4 != 0: F copied 4 bytes at a time), one particle, the widest
# D
WIDE_CASES = ((False, 2, 400, 192, 12), (False, 2, 400, 960, 12), (True, 6, 200, 448, 24))
WIDE_EDGES = ((True, 2, 37, 37, 10), (False, 3, 1, 100, 17), (True, 2, 400, 1024, 32))
# phase 13's depth: the UR5 step profiles' host window and the HIL path's
# optimizer steps (a UR5 step takes 2-3.6 s on the host)
UR5_STEPS = 3
UR5_EPOCHS = 1001  # of the config's 2001
# set by ``--full-profile``: profile the steps that the default run only
# times or runs (phase 9's Furuta SE step, phase 13's UR5 K1/K2 step, phase
# 14 (b)'s Furuta farm, every mode of every path of phase 15)
FULL_PROFILE = False


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_facts():
    """Print the card's name and power limit (``nvidia-smi``) and the
    software versions; returns the ``nvidia-smi`` line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def kernel_inputs(P, M, seed, dev, G=G, D=D):
    """Seeded inputs shaped like one rollout step's predict call; the inverse
    squared lengthscales scale as 6 / D, so that the SE part stays O(0.1-1)
    at every width."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)
    arrs = [
        np.exp(0.3 * f(G, D)) * (6.0 / D), np.exp(0.2 * f(G)), 0.1 * np.exp(0.3 * f(G, D + 1)),
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
    from torch.profiler import ProfilerActivity, profile

    from mcpilco_tpu_torch.utils.profiling import device_records

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiled window now and then comes back short of device records: a
    # kernel's time is its records' mean times its launches per call (its
    # records over ``iters``, rounded), and a window that lost more than a
    # tenth of a kernel's records is refused and profiled again (dividing a
    # short window's sum by ``iters`` reads the kernel low)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for name, us in device_records(prof):
            total[name] = total.get(name, 0.0) + us
            count[name] = count.get(name, 0) + 1
        calls = {k: max(1, round(n / iters)) * iters for k, n in count.items()}
        per = {k: total[k] / n * calls[k] / iters for k, n in count.items()}
        short = {k: n for k, n in count.items() if abs(n - calls[k]) > 0.1 * calls[k]}
        if per and not short:
            return per
        print(f"  [profile] kernel window refused: {len(count)} kernels, records per kernel "
              f"{count} for {iters} calls", flush=True)
    raise RuntimeError("torch.profiler recorded no whole kernel window on the card in 5 tries")


def named_us(per, name):
    return sum(t for k, t in per.items() if name in k)


def k1_us(per):
    """K1's kernels in a call's ``device_us`` record, its partial sums'
    left out: ``k1_forward`` (narrow), or ``k1_gen`` + ``k1_forward_wide``."""
    return named_us(per, "k1_forward") + named_us(per, "k1_gen")


def max_err(a, b):
    return float(torch.max(torch.abs(a - b)))


def cotangents(P, dev, G=G):
    wk = torch.linspace(0.5, 1.5, G * P, device=dev).reshape(G, P)
    wq = torch.linspace(-1.0, 1.0, G * P, device=dev).reshape(G, P)
    return wk, wq


def check_case(fp, use_poly, P, M, dev, G=G, D=D):
    """K1 and K2 against their plain versions at one shape, x*'s gradient
    through GramContract against autograd through the plain K1, and two
    calls bitwise equal.  Returns the max errors (K1, K2)."""
    args = kernel_inputs(P, M, seed=P + M + 10 * use_poly, dev=dev, G=G, D=D)
    wk, wq = cotangents(P, dev, G)
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
    kind = ("se+p2" if use_poly else "se") + ("" if D == 6 else f" D={D} G={G}")
    print(f"  {kind:5s} P={P:3d} M={M:4d}: K1 err {e_fwd:.3e} | K2 err {e_bwd:.3e} "
          f"(plain K2 {max_err(dx, dx_r):.3e}, autograd {max_err(g_k, g_r):.3e}) | "
          f"bitwise equal across calls", flush=True)
    return e_fwd, e_bwd


def check_edge(fp, use_poly, P, M, dev, G, D):
    """K1 and K2 at an edge of the wide path (``WIDE_EDGES``), each output held
    against a float64 evaluation of the plain versions: no farther from it
    than the float32 plain version is, within 4x plus 1e-6; and two calls
    bitwise equal.  At 'se+p2' D=32 M=1024 the dx* of ``kernel_inputs``
    reach ~1e3 and the float32 plain version itself lies ~3e-4 from float64,
    so against it an entry near 0 can miss GRAD_TOL by summation order
    alone.  Returns the max errors against the plain version (K1, K2)."""
    args = kernel_inputs(P, M, seed=P + M + 10 * use_poly, dev=dev, G=G, D=D)
    wk, wq = cotangents(P, dev, G)
    out = fp.fused_gram_contract(*args, use_poly, return_kf=True)
    dx = fp.fused_gram_contract_bwd_xstar(*args, out[2], wk, wq, use_poly)
    again = fp.fused_gram_contract(*args, use_poly, return_kf=True)
    dx_again = fp.fused_gram_contract_bwd_xstar(*args, again[2], wk, wq, use_poly)
    ref = fp.reference_gram_contract(*args, use_poly, return_kf=True)
    dx_r = fp.reference_gram_contract_bwd_xstar(*args, ref[2], wk, wq, use_poly)
    a64 = [t.double() for t in args]
    r64 = fp.reference_gram_contract(*a64, use_poly, return_kf=True)
    dx64 = fp.reference_gram_contract_bwd_xstar(*a64, r64[2], wk.double(), wq.double(),
                                                use_poly)
    torch.cuda.synchronize()
    kind = f"{'se+p2' if use_poly else 'se'} D={D} G={G} P={P} M={M}"
    errs = []
    for name, got, plain, exact in zip(("kalpha", "quad", "kF", "dx*"), (*out, dx),
                                       (*ref, dx_r), (*r64, dx64)):
        e_k, e_p = max_err(got.double(), exact), max_err(plain.double(), exact)
        errs.append(f"{name} {e_k:.3e} (plain {e_p:.3e})")
        if not e_k <= 4 * e_p + 1e-6:
            raise RuntimeError(f"edge {kind}: the kernel's {name} is {e_k:.3e} from float64, "
                               f"the plain version's {e_p:.3e}")
    if not all(torch.equal(a, b) for a, b in zip((*out, dx), (*again, dx_again))):
        raise RuntimeError(f"edge {kind}: two calls on the same inputs differ")
    print(f"  edge {kind}: against float64 {', '.join(errs)} | bitwise equal across calls",
          flush=True)
    return (max(max_err(a, b) for a, b in zip(out, ref)), max_err(dx, dx_r))


def check_gen(fp, use_poly, P, M, dev, G, D):
    """The wide path's generation kernel alone (``fused_gram_gen``: the
    masked k* and kalpha) against ``reference_gram_gen`` at FWD_TOL, on
    phase 2's inputs of that shape; returns the max error."""
    args = kernel_inputs(P, M, seed=P + M + 10 * use_poly, dev=dev, G=G, D=D)
    gen_in = (*args[:8], args[9])
    got = fp.fused_gram_gen(*gen_in, use_poly)
    want = fp.reference_gram_gen(*gen_in, use_poly)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **FWD_TOL)
    err = max(max_err(a, b) for a, b in zip(got, want))
    print(f"  gen {'se+p2' if use_poly else 'se'} D={D} G={G} P={P} M={M}: k* and kalpha "
          f"against reference_gram_gen, max err {err:.3e}", flush=True)
    return err


def time_kernels(fp, use_poly, M, dev, P=400, G=G, D=D):
    """K1 (as the main path calls it, saving kF) and K2 against their plain
    versions, and above 8 dims the generation kernel alone against its
    twin: CUDA-event and device times, in ms.  K1's kernel time holds its
    generation pass above 8 dims (``gen_kernel`` apart)."""
    args = kernel_inputs(P, M, seed=M + 10 * use_poly, dev=dev, G=G, D=D)
    wk, wq = cotangents(P, dev, G)
    kf = fp.fused_gram_contract(*args, use_poly, return_kf=True)[2]
    kf_r = fp.reference_gram_contract(*args, use_poly, return_kf=True)[2]
    fns = dict(
        k1=lambda: fp.fused_gram_contract(*args, use_poly, return_kf=True),
        k1_plain=lambda: fp.reference_gram_contract(*args, use_poly),
        k2=lambda: fp.fused_gram_contract_bwd_xstar(*args, kf, wk, wq, use_poly),
        k2_plain=lambda: fp.reference_gram_contract_bwd_xstar(*args, kf_r, wk, wq, use_poly),
    )
    if D > fp.NARROW_D:
        fns.update(gen=lambda: fp.fused_gram_gen(*args[:8], args[9], use_poly),
                   gen_plain=lambda: fp.reference_gram_gen(*args[:8], args[9], use_poly))
    events = {k: cuda_ms(fn) for k, fn in fns.items()}
    per = {k: device_us(fn) for k, fn in fns.items()}
    dev_ms = {k: 1e-3 * sum(p.values()) for k, p in per.items()}
    dev_ms["k1_kernel"] = 1e-3 * k1_us(per["k1"])
    dev_ms["gen_kernel"] = 1e-3 * named_us(per["k1"], "k1_gen")
    dev_ms["k2_kernel"] = 1e-3 * named_us(per["k2"], "k2_backward_xstar")
    kind = ("se+p2" if use_poly else "se") + ("" if D == 6 else f" D={D} G={G}")
    gen = (f" (its generation {dev_ms['gen_kernel']:.4f}; alone {dev_ms['gen']:.4f}, plain "
           f"{dev_ms['gen_plain']:.4f})" if "gen" in fns else "")
    print(f"  time {kind:5s} P={P} M={M}, device ms: K1 kernel {dev_ms['k1_kernel']:.4f}{gen} "
          f"(call {dev_ms['k1']:.4f}) plain {dev_ms['k1_plain']:.4f} | K2 kernel "
          f"{dev_ms['k2_kernel']:.4f} (call {dev_ms['k2']:.4f}) plain {dev_ms['k2_plain']:.4f}; "
          f"back to back (CUDA events): K1 {events['k1']:.4f} plain {events['k1_plain']:.4f} | "
          f"K2 {events['k2']:.4f} plain {events['k2_plain']:.4f}", flush=True)
    return dev_ms


def check_kernels(fp, dev):
    """Phase 2: the sweep, the timings, and the launch facts; returns
    per-kernel records for the kernels line."""
    from mcpilco_tpu_torch.utils.profiling import bound

    rec = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0},
           "gen": {"max_abs_err": 0.0, "by_shape": []}}
    for use_poly in (False, True):
        for P in SWEEP_P:
            for M in SWEEP_M:
                e_fwd, e_bwd = check_case(fp, use_poly, P, M, dev)
                rec["fwd"]["max_abs_err"] = max(rec["fwd"]["max_abs_err"], e_fwd)
                rec["bwd"]["max_abs_err"] = max(rec["bwd"]["max_abs_err"], e_bwd)
    for use_poly, M in ((True, M_FLAGSHIP), (False, M_FLAGSHIP), (False, M_PMS)):
        t = time_kernels(fp, use_poly, M, dev)
        if use_poly:  # the flagship shapes
            for key, work, kernel in (("fwd", fp.k1_work, "k1"), ("bwd", fp.k2_work, "k2")):
                ms, by = bound(work(1, 400, M, use_poly, G, D))
                rec[key].update(ms=t[f"{kernel}_kernel"], plain_ms=t[f"{kernel}_plain"],
                                bound_ms=ms, bound_by=by, library_ms=None)
    for M in (M_FLAGSHIP, M_PMS):
        k1, k2 = fp.launch_blocks(G, 400, M)
        print(f"  blocks per launch at P=400 M={M}: K1 {k1}, K2 {k2} (132 SMs)", flush=True)
    for key in rec:
        rec[key]["by_shape"] = []
    for use_poly, g, P, M, d in WIDE_CASES:
        errs = (*check_case(fp, use_poly, P, M, dev, G=g, D=d),
                check_gen(fp, use_poly, P, M, dev, G=g, D=d))
        t = time_kernels(fp, use_poly, M, dev, P=P, G=g, D=d)
        shape = f"{'se+p2' if use_poly else 'se'} D={d} G={g} P={P} M={M}"
        for key, work, kernel, err in (("fwd", fp.k1_work, "k1", errs[0]),
                                       ("bwd", fp.k2_work, "k2", errs[1]),
                                       ("gen", fp.gen_work, "gen", errs[2])):
            ms, by = bound(work(1, P, M, use_poly, g, d))
            rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], err)
            rec[key]["by_shape"].append(dict(shape=shape, ms=t[f"{kernel}_kernel"],
                                             plain_ms=t[f"{kernel}_plain"], bound_ms=ms,
                                             bound_by=by, max_abs_err=err))
        plan = fp.wide_plan(g, P, M)
        blocks = {k: v["blocks"] for k, v in plan.items() if k != "Pp"}
        print(f"  wide {shape}: bound K1 {rec['fwd']['by_shape'][-1]['bound_ms']:.4f} ms, "
              f"K2 {rec['bwd']['by_shape'][-1]['bound_ms']:.4f} ms "
              f"({rec['fwd']['by_shape'][-1]['bound_by']}), generation "
              f"{rec['gen']['by_shape'][-1]['bound_ms']:.4f} ms "
              f"({rec['gen']['by_shape'][-1]['bound_by']}); blocks per launch {blocks} "
              f"({fp.SMS} SMs), tiles {[v['tile'] for k, v in plan.items() if k != 'Pp']}",
              flush=True)
    for use_poly, g, P, M, d in WIDE_EDGES:
        errs = (*check_edge(fp, use_poly, P, M, dev, G=g, D=d),
                check_gen(fp, use_poly, P, M, dev, G=g, D=d))
        for key, err in zip(("fwd", "bwd", "gen"), errs):
            rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], err)
    # the generation kernel's own row: UR5's shape, the widest main path's
    rec["gen"].update({k: v for k, v in rec["gen"]["by_shape"][-1].items()
                       if k in ("ms", "plain_ms", "bound_ms", "bound_by")}, library_ms=None)
    lane_errs, lane_rows = check_lanes(fp, dev)
    for key, extra in zip(("fwd", "bwd"), lane_rows):
        rec[key]["by_shape"] += extra
    for e_fwd, e_bwd in (lane_errs, check_predict_lanes(dev), check_predict_wide(dev)):
        rec["fwd"]["max_abs_err"] = max(rec["fwd"]["max_abs_err"], e_fwd)
        rec["bwd"]["max_abs_err"] = max(rec["bwd"]["max_abs_err"], e_bwd)
    return rec


def check_lanes(fp, dev):
    """Lane-batched K1 and K2: every lane against the plain version at
    FWD_TOL / GRAD_TOL and bitwise against the L=1 launch on that lane's
    inputs; device time per launch beside L x the L=1 time, and for
    ``LANE_ROWS`` the plain versions' time.  Returns the max errors (K1,
    K2) and the ``LANE_ROWS`` records (K1 rows, K2 rows)."""
    from mcpilco_tpu_torch.utils.profiling import bound

    worst = [0.0, 0.0]
    rows = ([], [])
    for use_poly, P, M, lane_counts, *gd in LANE_CASES:
        g, d = gd or (G, D)
        kind = ("se+p2" if use_poly else "se") + ("" if d == D else f" D={d}")
        one_us = None
        for L in lane_counts:
            per = [kernel_inputs(P, M, seed=7 + P + M + 1000 * l, dev=dev, G=g, D=d)
                   for l in range(L)]
            args = [torch.stack(ts) for ts in zip(*per)]
            wk, wq = (torch.stack([(l + 1.0) * w for l in range(L)])
                      for w in cotangents(P, dev, g))
            ka, qd, kf = fp.fused_gram_contract(*args, use_poly, return_kf=True)
            dx = fp.fused_gram_contract_bwd_xstar(*args, kf, wk, wq, use_poly)
            errs = [0.0, 0.0]
            for l in range(L):
                one = fp.fused_gram_contract(*per[l], use_poly, return_kf=True)
                dx1 = fp.fused_gram_contract_bwd_xstar(*per[l], one[2], wk[l], wq[l], use_poly)
                ref = fp.reference_gram_contract(*per[l], use_poly, return_kf=True)
                dxr = fp.reference_gram_contract_bwd_xstar(*per[l], ref[2], wk[l], wq[l],
                                                           use_poly)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip((ka[l], qd[l], kf[l], dx[l]),
                                                             (*one, dx1))):
                    raise RuntimeError(f"{kind} L={L} P={P} M={M}: lane {l} differs from its "
                                       f"L=1 launch")
                for got, want in zip((ka[l], qd[l], kf[l]), ref):
                    torch.testing.assert_close(got, want, **FWD_TOL)
                torch.testing.assert_close(dx[l], dxr, **GRAD_TOL)
                errs[0] = max([errs[0]] + [max_err(a, b) for a, b in zip(one, ref)])
                errs[1] = max(errs[1], max_err(dx1, dxr))
            worst = [max(w, e) for w, e in zip(worst, errs)]
            per_us = {
                "k1": k1_us(device_us(lambda: fp.fused_gram_contract(
                    *args, use_poly, return_kf=True))),
                "k2": named_us(device_us(lambda: fp.fused_gram_contract_bwd_xstar(
                    *args, kf, wk, wq, use_poly)), "k2_backward_xstar"),
            }
            one_us = one_us or per_us
            b1, b2 = (bound(w(L, P, M, use_poly, g, d)) for w in (fp.k1_work, fp.k2_work))
            print(f"  lanes {kind:5s} L={L} P={P} M={M}: every lane bitwise equal to its L=1 "
                  f"launch; max err K1 {errs[0]:.3e} K2 {errs[1]:.3e} | device us per launch: "
                  f"K1 {per_us['k1']:.2f} (L x L=1: {L * one_us['k1']:.2f}, bound "
                  f"{1e3 * b1[0]:.2f}), K2 {per_us['k2']:.2f} (L x L=1: {L * one_us['k2']:.2f}, "
                  f"bound {1e3 * b2[0]:.2f}); blocks {fp.launch_blocks(g, P, M, L, d)}",
                  flush=True)
            if (use_poly, P, M, L, d) in LANE_ROWS:
                plain = {
                    "k1": 1e-3 * sum(device_us(lambda: fp.reference_gram_contract(
                        *args, use_poly)).values()),
                    "k2": 1e-3 * sum(device_us(lambda: fp.reference_gram_contract_bwd_xstar(
                        *args, kf, wk, wq, use_poly)).values()),
                }
                shape = f"{'se+p2' if use_poly else 'se'} D={d} G={g} L={L} P={P} M={M}"
                for i, (k, b, e) in enumerate((("k1", b1, errs[0]), ("k2", b2, errs[1]))):
                    rows[i].append(dict(shape=shape, ms=1e-3 * per_us[k], plain_ms=plain[k],
                                        bound_ms=b[0], bound_by=b[1], max_abs_err=e))
                print(f"  lanes {shape}: plain versions K1 {plain['k1']:.4f} ms, K2 "
                      f"{plain['k2']:.4f} ms per call", flush=True)
    return tuple(worst), rows


def check_predict_lanes(dev):
    """``MultiGP.predict`` on the card as the lane paths call it: two
    restart lanes' x* [2, 400, D] against one 'se' posterior, folded into
    one P=800 launch (phase 8), at M=128 and 448, and four farm lanes' x*
    [4, 400, D] against four 'se+p2' lane posteriors at M=128, one L=4
    launch (phase 7).  Mean, var and x*'s gradient, lane by lane, against
    ``MultiGP._predict_plain`` on that lane at FWD_TOL / GRAD_TOL; returns
    the max errors (forward, gradient)."""
    from mcpilco_tpu_torch.models import kernels as K
    from mcpilco_tpu_torch.models.gp import MultiGP, Posterior, tree_map

    dims = tuple(range(D))
    worst = [0.0, 0.0]
    for label, kern, L, shared, M in (
            ("restart fold se", K.SEArd(dims), 2, True, M_SMALL),
            ("restart fold se", K.SEArd(dims), 2, True, M_PMS),
            ("farm lanes se+p2", K.se_plus_volterra(dims, 2), 4, False, M_SMALL)):
        gp = MultiGP(kernel=kern, num_heads=G)
        base = gp.init_params(device=dev)
        per = [kernel_inputs(400, M, seed=11 + M + 100 * l, dev=dev) for l in range(L)]
        # var_factor scaled so that quad stays below the prior and var off its floor
        posts = [Posterior(x_tr=a[6], mask=a[9], alpha=a[7], var_factor=0.1 * a[8],
                           norm=torch.ones(G, device=dev)) for a in per]
        if shared:
            lanes = [(base, posts[0])] * L
            params, post = base, posts[0]
        else:
            # lengthscales differ per lane; the polynomial terms at 0.1 of
            # their unit init, the scale of kernel_inputs
            se, p1, p2 = base.kernel
            small = lambda p: {"log_sigma_diag": p["log_sigma_diag"] + 0.5 * math.log(0.1)}
            lanes = [(base._replace(kernel=(
                dict(se, log_lengthscales=se["log_lengthscales"] + 0.1 * l), small(p1),
                small(p2))), posts[l]) for l in range(L)]
            params = tree_map(lambda *ts: torch.stack(ts), *(p for p, _ in lanes))
            post = tree_map(lambda *ts: torch.stack(ts), *posts)
        x_star = torch.stack([a[5] for a in per])
        wk, wq = (torch.stack([(l + 1.0) * w for l in range(L)]) for w in cotangents(400, dev))

        def fwd_bwd(fn, p, q, xs, a, b):
            xs = xs.clone().requires_grad_(True)
            mean, var = fn(p, q, xs)
            g = torch.autograd.grad(torch.sum(a * mean) + torch.sum(b * var), xs)[0]
            return mean.detach(), var.detach(), g

        mean, var, g = fwd_bwd(gp.predict, params, post, x_star, wk, wq)
        errs = [0.0, 0.0]
        for l, (p, q) in enumerate(lanes):
            m_r, v_r, g_r = fwd_bwd(gp._predict_plain, p, q, x_star[l], wk[l], wq[l])
            torch.cuda.synchronize()
            torch.testing.assert_close(mean[l], m_r, **FWD_TOL)
            torch.testing.assert_close(var[l], v_r, **FWD_TOL)
            torch.testing.assert_close(g[l], g_r, **GRAD_TOL)
            errs = [max(errs[0], max_err(mean[l], m_r), max_err(var[l], v_r)),
                    max(errs[1], max_err(g[l], g_r))]
        worst = [max(w, e) for w, e in zip(worst, errs)]
        print(f"  predict {label} L={L} P=400 M={M}: every lane against _predict_plain, max err "
              f"mean/var {errs[0]:.3e}, x* gradient {errs[1]:.3e}", flush=True)
    return tuple(worst)


def check_predict_wide(dev):
    """``MultiGP.predict`` on the card above 8 input dims: a full-dims SE over
    12 (the Furuta ``semiparametric=False`` model) and an SE+P(2) over 24 with
    6 heads (UR5's).  Each call must launch K1 and K2 once (no plain path,
    no exception) and agree with ``_predict_plain`` at FWD_TOL / GRAD_TOL,
    x*'s gradient included.  Returns the max errors (forward, gradient)."""
    from mcpilco_tpu_torch.models import kernels as K
    from mcpilco_tpu_torch.models.gp import MultiGP, Posterior
    from mcpilco_tpu_torch.ops import fused_predict as fp

    worst = [0.0, 0.0]
    for use_poly, g, P, M, d in (WIDE_CASES[0], WIDE_CASES[2]):
        dims = tuple(range(d))
        gp = MultiGP(kernel=K.se_plus_volterra(dims, 2) if use_poly else K.SEArd(dims),
                     num_heads=g)
        ls = {"lengthscales": math.sqrt(d / 6.0)}
        small = {"sigma_diag": math.sqrt(0.1)}
        params = gp.init_params(per_head_overrides=[
            {"member_overrides": [ls, small, small]} if use_poly else ls] * g, device=dev)
        a = kernel_inputs(P, M, seed=23 + M + d, dev=dev, G=g, D=d)
        post = Posterior(x_tr=a[6], mask=a[9], alpha=a[7], var_factor=0.1 * a[8],
                         norm=torch.ones(g, device=dev))
        wk, wq = cotangents(P, dev, g)
        out = {}
        for name, fn in (("predict", gp.predict), ("plain", gp._predict_plain)):
            fp.reset_launches()
            xs = a[5].clone().requires_grad_(True)
            mean, var = fn(params, post, xs)
            grad = torch.autograd.grad(torch.sum(wk * mean) + torch.sum(wq * var), xs)[0]
            torch.cuda.synchronize()
            out[name] = (mean.detach(), var.detach(), grad,
                         dict(fp.launches, **fp.gen_launches))
        if (out["predict"][3] != {"fwd": 1, "bwd": 1, "gen": 1}
                or out["plain"][3] != {"fwd": 0, "bwd": 0, "gen": 0}):
            raise RuntimeError(f"D={d}: predict launched {out['predict'][3]}, the plain path "
                               f"{out['plain'][3]}")
        for i, tol in ((0, FWD_TOL), (1, FWD_TOL), (2, GRAD_TOL)):
            torch.testing.assert_close(out["predict"][i], out["plain"][i], **tol)
        errs = [max(max_err(out["predict"][i], out["plain"][i]) for i in (0, 1)),
                max_err(out["predict"][2], out["plain"][2])]
        worst = [max(w, e) for w, e in zip(worst, errs)]
        print(f"  predict {'se+p2' if use_poly else 'se'} D={d} G={g} P={P} M={M} on the card: "
              f"K1 (with its generation pass) and K2 launched once each; against "
              f"_predict_plain max err mean/var "
              f"{errs[0]:.3e}, x* gradient {errs[1]:.3e}", flush=True)
    return tuple(worst)


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
              f"{1e-3 * k1_us(per['fused']):.4f}, K2 "
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
    paths = {"plain": gp._predict_plain}
    if gp._fused_structure() is not None:
        paths["kernel"] = gp._predict_fused
    with torch.no_grad():
        got = {name: fn(gp_params, post, xs) for name, fn in paths.items()}
        m_64, v_64 = gp._predict_plain(to64(gp_params), to64(post), xs.double())
    torch.cuda.synchronize()
    errs = {name: (max_err(m.double(), m_64), max_err(v.double(), v_64))
            for name, (m, v) in got.items()}
    print(f"  fitted posterior M={post.x_tr.shape[-2]}, P=400, max |mean| "
          f"{float(m_64.abs().max()):.3e}, max var {float(v_64.max()):.3e}; against float64: "
          + " | ".join(f"{name} mean err {e[0]:.3e} var err {e[1]:.3e}"
                       for name, e in sorted(errs.items())), flush=True)
    if not all(math.isfinite(e) for pair in errs.values() for e in pair):
        raise RuntimeError(f"non-finite prediction on the fitted posterior: {errs}")
    for i, what in enumerate(("mean", "var")):
        if "kernel" in errs and errs["kernel"][i] > 4 * errs["plain"][i] + 1e-6:
            raise RuntimeError(f"K1 {what} on the fitted posterior is less accurate than the "
                               f"plain path: {errs}")


def policy_step(agent, num_trials, T, fp, dev, expect_m=None, profile=False, trials=None,
                epochs=1501):
    """Collect ``num_trials`` exploration trials (or ingest the given
    ``trials`` of another agent on the same plant), fit the GP for
    ``epochs`` epochs, hold K1 (where the kernel structure has one) and the
    plain path on the fitted posterior against float64, then time 10
    optimizer steps at full width, graphed, as (run(GRAPH_BASE + 10) -
    run(GRAPH_BASE)) / 10 (the call's warm-up and capture left out), or with
    ``profile`` 2 as the host window of the step profile; with kernels the
    learning-curve check.  Returns the agent."""
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.utils import prng
    from mcpilco_tpu_torch.utils.profiling import GRAPH_BASE, host_ms, profile_steps

    t_plant = time.perf_counter()
    for i in range(num_trials):
        if trials is None:
            agent.collect(T, trial_index=i, exploration=True)
        else:
            agent._ingest(trials[i])
    plant_s = time.perf_counter() - t_plant
    t_fit = time.perf_counter()
    info = agent.fit_model(ModelFitOptions(num_epochs=epochs))
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
    fp.reset_launches()
    opt = agent.optimizer
    runs = {}

    def run(n):
        runs[n] = opt.optimize(prng.fold(prng.root_key(7), 1), agent.policy_params,
                               agent.gp_params, agent.posterior, num_opt_steps=n, lr0=0.01,
                               p_dropout0=0.25)
        torch.cuda.synchronize()

    timed = 2 if profile else 10
    if profile:
        # the timed steps are the profile's host window: (run(base + 2) -
        # run(base)) / 2, base = GRAPH_BASE steps (the call that captures);
        # busy over 2 profiled steps (~47K events each at horizon 150)
        p = profile_steps(run, host_steps=timed, window=2)
        res, ms_step, steps = runs[GRAPH_BASE + timed], p["host_ms"], GRAPH_BASE + timed
    else:
        ms_step = host_ms(run, timed)[0]
        res, steps = runs[GRAPH_BASE + timed], GRAPH_BASE + timed
    costs = res.cost_history[: res.steps_done].numpy()
    if res.steps_done != steps or not np.all(np.isfinite(costs)):
        raise RuntimeError(f"policy step: {res.steps_done} steps, costs {costs}")
    kernels = agent.gp._fused_structure() is not None
    if (min(fp.launches.values()) > 0) != kernels or (max(fp.launches.values()) > 0) != kernels:
        raise RuntimeError(f"the policy step's launches {fp.launches} do not match its kernel "
                           f"structure {agent.gp._fused_structure()}")
    print(f"  {timed} steps at P={opt.num_particles}, horizon {opt.horizon} (graphed): "
          f"{ms_step:.2f} ms/step, cost {costs[0]:.3f} -> {costs[-1]:.3f} over {steps} steps, "
          f"launches {dict(fp.launches)}", flush=True)
    if profile:
        top = ", ".join(f"{k[:40]} {v:.0f}" for k, v in list(p["events_by_kernel"].items())[:4])
        print(f"  step profile: {p['host_ms']:.2f} host ms/step, device busy "
              f"{p['busy_ms']:.2f} ms/step, device events per step {p['events']:.0f}, idle "
              f"share {p['idle']:.3f}; most events per step: {top}", flush=True)
    if kernels:
        learning_curve(agent, fp)
    return agent


def learning_curve(agent, fp, steps=10):
    """The gate for a kernel change: ``steps`` optimizer steps from one key,
    once through the kernels and once through ``MultiGP._predict_plain``;
    prints both cost trajectories and the gap of their last costs."""
    from mcpilco_tpu_torch.utils import prng

    curves = {name: learning_run(agent, fp, name, prng.fold(prng.root_key(7), 2),
                                 agent.policy_params, steps)
              for name in ("kernel", "plain")}
    compare_curves(curves, steps)


def learning_run(agent, fp, name, key, params, steps, trial_index=0):
    """``steps`` optimizer steps from ``key`` and ``params`` through the
    kernels (``name`` 'kernel') or ``MultiGP._predict_plain`` ('plain');
    returns the cost trajectory, checked finite and launched as named."""
    from mcpilco_tpu_torch.models.gp import MultiGP

    with (mock.patch.object(MultiGP, "predict", MultiGP._predict_plain) if name == "plain"
          else contextlib.nullcontext()):
        fp.reset_launches()
        res = agent.optimizer.optimize(key, params, agent.gp_params, agent.posterior,
                                       num_opt_steps=steps, lr0=0.01, p_dropout0=0.25,
                                       trial_index=trial_index)
        torch.cuda.synchronize()
    costs = res.cost_history[: res.steps_done].numpy()
    if res.steps_done != steps or not np.all(np.isfinite(costs)):
        raise RuntimeError(f"learning curve ({name}): {res.steps_done} steps, costs {costs}")
    if (min(fp.launches.values()) > 0) != (name == "kernel"):
        raise RuntimeError(f"learning curve ({name}): kernel launches {fp.launches}")
    return costs


def compare_curves(curves, steps):
    """Print the kernel and plain cost trajectories and their last costs' gap."""
    gap = abs(curves["kernel"][-1] - curves["plain"][-1]) / abs(curves["plain"][-1])
    for name, c in curves.items():
        print(f"  learning curve, {steps} steps from one key, {name:6s}: "
              f"{' '.join(f'{v:.4f}' for v in c)}", flush=True)
    print(f"  learning curve: last costs {curves['kernel'][-1]:.4f} (kernel) against "
          f"{curves['plain'][-1]:.4f} (plain), gap {100 * gap:.3f}%", flush=True)


def main_path(built, fp):
    """``reinforce`` of a freshly built agent; returns its kernel launches:
    both kernels on every launch-eligible path, none where the GP's kernel
    structure has no fused kernel (the Furuta Sum(SE, Linear), SOR)."""
    agent, kwargs = built
    fp.reset_launches()
    logs = agent.reinforce(**kwargs)
    torch.cuda.synchronize()
    launches = dict(fp.launches)
    for i, lg in enumerate(logs):
        c = lg.cost_history
        if lg.steps_done == 0 or not np.all(np.isfinite(c)):
            raise RuntimeError(f"trial {i}: {lg.steps_done} steps, costs {c}")
    kernels = agent.gp.approx == "exact" and agent.gp._fused_structure() is not None
    if (min(launches.values()) > 0) != kernels or (max(launches.values()) > 0) != kernels:
        raise RuntimeError(f"the main path's launches {launches} do not match its kernel "
                           f"structure {agent.gp._fused_structure()} ({agent.gp.approx})")
    for i, lg in enumerate(logs):
        print(f"  trial {i}: {lg.steps_done} steps, cost {lg.cost_history[0]:.3f} -> "
              f"{lg.cost_history[-1]:.3f}, {1e3 * lg.wall_clock_s / lg.steps_done:.2f} ms/step",
              flush=True)
    launches.update(fp.gen_launches)
    wide = kernels and agent.posterior.x_tr.shape[-1] > fp.NARROW_D
    if launches["gen"] != (launches["fwd"] if wide else 0):
        raise RuntimeError(f"the generation kernel's launches {launches} do not match the "
                           f"path's input dims ({'above' if wide else 'at most'} 8)")
    print(f"  launches in reinforce: {launches}", flush=True)
    return launches


def lane_runner(agent, keys, params, gp_params, post, trial_index):
    def run(n):
        agent.optimizer.optimize_lanes(keys, params, gp_params, post, n, 0.01, 0.25, trial_index)
        torch.cuda.synchronize()
    return run


def run_farm(fp, dev, scen, cfg, seeds, kernels, host_plant=False):
    """``SeedFarm.run`` over ``seeds`` of ``scen.build(cfg, dev)`` (with
    ``host_plant`` its plant behind :class:`HostODEPlant`), its K1/K2
    launches counted from 0: with ``kernels`` every launch carries one lane
    per seed, else there is none.  Returns (agent, farm, result, launches)."""
    from mcpilco_tpu_torch.parallel.multiseed import SeedFarm

    agent, kwargs = scen.build(cfg, dev)
    if host_plant:
        agent.plant = HostODEPlant(agent.plant)
    S = len(seeds)
    farm = SeedFarm(agent, list(seeds),
                    policy_init_fn=lambda k: scen.policy_init(cfg, agent.policy, k, dev))
    fp.reset_launches()
    t0 = time.perf_counter()
    res = farm.run(**kwargs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, lanes = dict(fp.launches), dict(fp.launched_lanes)
    if kernels and (min(launches.values()) == 0
                    or any(lanes[k] != S * launches[k] for k in launches)):
        raise RuntimeError(f"the farm did not run K1/K2 with {S} lanes: launches {launches}, "
                           f"lanes {lanes}")
    if not kernels and max(launches.values()) > 0:
        raise RuntimeError(f"the farm launched K1/K2 for a model without a kernel structure: "
                           f"{launches}")
    for t, log in enumerate(res.trial_logs):
        hist = [log.cost_history[i, : log.steps_done[i]] for i in range(S)]
        if min(log.steps_done) == 0 or not all(np.all(np.isfinite(h)) for h in hist):
            raise RuntimeError(f"farm trial {t}: steps {log.steps_done}, costs {hist}")
        print(f"  farm trial {t}: steps {log.steps_done.tolist()}, last costs "
              f"{[round(float(h[-1]), 4) for h in hist]}, mll {log.mll_last.round(2).tolist()}",
              flush=True)
    final = res.final_true
    if any(np.allclose(final[i], final[j]) for i in range(S) for j in range(i)):
        raise RuntimeError("two farmed seeds ended with the same trajectory")
    M = farm.posterior.x_tr.shape[1]
    per = (f", lanes per launch {lanes['fwd'] // launches['fwd']}; blocks per launch at M={M}: "
           f"{fp.launch_blocks(agent.gp.num_heads, agent.optimizer.num_particles, M, S)}"
           if kernels else f" (M={M})")
    print(f"  farm of {S} seeds, {len(res.trial_logs)} trials in {run_s:.1f} s; launches "
          f"{launches}{per}", flush=True)
    return agent, farm, res, launches


def farm_step_profile(agent, farm, host_steps, window, lane_one=False):
    """The farm's optimizer step on its last posteriors beside one seed's
    (the seed's posterior without a lane axis: the single-seed step), and
    with ``lane_one`` beside that seed kept as a lane axis of size 1, which
    must not issue more device events per step than the single-seed step.
    The profiler's count of one step moves by up to ~0.4% between windows
    of the same code (H100 runs); the trap this guards against (autograd
    adding two reductions and two fills per rollout step) adds ~1.35% to a
    4PMS step, so the check fails above +0.7%.  Returns the profiles."""
    from mcpilco_tpu_torch.models.gp import tree_map
    from mcpilco_tpu_torch.utils import prng
    from mcpilco_tpu_torch.utils.profiling import profile_steps

    S = len(farm.seeds)
    keys = [prng.fold(prng.stream(k, prng.STREAM_ROLLOUT), 1) for k in farm.keys]
    first = lambda tree: tree_map(lambda t: t[:1], tree)
    one = lambda tree: tree_map(lambda t: t[0], tree)
    runs = {"farm": lane_runner(agent, keys, farm.policy_params, farm.gp_params, farm.posterior, 1),
            "one": lane_runner(agent, keys[:1], first(farm.policy_params), one(farm.gp_params),
                               one(farm.posterior), 1)}
    if lane_one:
        runs["lane1"] = lane_runner(agent, keys[:1], first(farm.policy_params),
                                    first(farm.gp_params), first(farm.posterior), 1)
    p = {k: profile_steps(run, host_steps=host_steps, window=window) for k, run in runs.items()}
    f, o = p["farm"], p["one"]
    print(f"  farm step, S={S}: {f['host_ms']:.2f} ms/step of all seeds ({f['host_ms'] / S:.2f} "
          f"ms/seed-step) against S x one seed's {S * o['host_ms']:.2f} (one seed "
          f"{o['host_ms']:.2f}); device busy {f['busy_ms']:.2f} ms/step (one seed "
          f"{o['busy_ms']:.2f}); device events per step {f['events']:.0f} (one seed "
          f"{o['events']:.0f}); idle share {f['idle']:.3f} (one seed {o['idle']:.3f})", flush=True)
    if lane_one:
        l1 = p["lane1"]
        a, b = l1["events_by_kernel"], o["events_by_kernel"]
        diff = sorted(((k, a.get(k, 0.0) - b.get(k, 0.0)) for k in a.keys() | b.keys()
                       if a.get(k, 0.0) != b.get(k, 0.0)), key=lambda kv: -abs(kv[1]))
        print(f"  one seed as a lane axis of size 1: {l1['host_ms']:.2f} ms/step, device busy "
              f"{l1['busy_ms']:.2f} ms/step, device events per step {l1['events']:.1f} against "
              f"the single-seed step's {o['events']:.1f}; by kernel (lane axis - single): "
              f"{', '.join(f'{k[:40]} {v:+.1f}' for k, v in diff[:6]) or 'equal'}", flush=True)
        if l1["events"] > 1.007 * o["events"]:
            raise RuntimeError(f"a lane axis of size 1 added device events to the step: "
                               f"{l1['events']} against {o['events']}")
    return p


def farmed_against_alone(scen, cfg, farm, res, dev, steps, tol):
    """The second seed's first ``steps`` costs of trial 0, farmed and trained
    alone: the largest gap relative to the cost alone must stay below
    ``tol``."""
    i = 1
    alone, kw = scen.build(dataclasses.replace(cfg, seed=farm.seeds[i], num_trials=1,
                                               opt_steps=(steps,)), dev)
    alone.reinforce(**kw, verbose=False)
    a = alone.trial_logs[0].cost_history
    f = res.trial_logs[0].cost_history[i, :steps]
    gap = float(np.max(np.abs(f - a) / np.abs(a)))
    print(f"  seed {farm.seeds[i]}, {steps} steps of trial 0, farmed: "
          f"{' '.join(f'{v:.4f}' for v in f)}", flush=True)
    print(f"  seed {farm.seeds[i]}, {steps} steps of trial 0, alone:  "
          f"{' '.join(f'{v:.4f}' for v in a)} (largest gap {gap:.2e} relative)", flush=True)
    if not gap < tol:
        raise RuntimeError(f"the farmed seed left the seed trained alone: gap {gap:.2e}")
    return gap


def farm_chunk_check(farm, fp, K=FARM_CHUNK, steps=10):
    """The farm's ``improve_policy`` with ``chunk_steps_override=K`` against
    the default chunks, from the same params on the same posteriors: costs,
    steps and params bitwise equal; host reads 1 + ceil((steps - 1) / K)
    (the uncaptured first iteration is a chunk of its own) against the
    default's 2; ``progress_cb`` ticking once per read; K1/K2 with one lane
    per seed.  Returns the launches of both calls."""
    from mcpilco_tpu_torch.control.mc_pilco import PolicyOptOptions
    from mcpilco_tpu_torch.control.trainer import graph_counts, reset_graph_counts

    S = len(farm.seeds)
    opts = PolicyOptOptions(opt_steps=steps, learning_rate=0.01, p_dropout=0.25)
    params, ticks, out = farm.policy_params, [], {}
    farm.progress_cb = lambda: ticks.append(1)
    for override in (None, K):
        farm.policy_params, farm.chunk_steps_override = params, override
        reset_graph_counts()
        fp.reset_launches()
        ticks.clear()
        cost, done, reinits = farm.improve_policy(opts, 1)
        torch.cuda.synchronize()
        out[override] = dict(cost=cost, done=done, reinits=int(reinits.sum()),
                             params=farm.policy_params, reads=graph_counts["reads"],
                             ticks=len(ticks), launches=dict(fp.launches),
                             lanes=dict(fp.launched_lanes))
    farm.progress_cb = farm.chunk_steps_override = None
    a, b = out[None], out[K]
    want = (2, 1 + -(-(steps - 1) // K))
    if not (np.array_equal(a["cost"], b["cost"]) and np.array_equal(a["done"], b["done"])
            and same_tree(a["params"], b["params"])):
        raise RuntimeError(f"chunk_steps_override={K} left the default farm: costs "
                           f"{a['cost'][:, -1]} against {b['cost'][:, -1]}")
    for r in (a, b):
        if r["ticks"] != r["reads"] or r["launches"]["fwd"] == 0 or any(
                r["lanes"][k] != S * r["launches"][k] for k in r["launches"]):
            raise RuntimeError(f"farm chunks: {r['ticks']} ticks for {r['reads']} reads, "
                               f"launches {r['launches']}, lanes {r['lanes']}")
    if (a["reinits"] + b["reinits"]) == 0 and (a["reads"], b["reads"]) != want:
        raise RuntimeError(f"farm chunks: host reads {a['reads']} / {b['reads']}, want {want}")
    print(f"  farm chunks, {steps} steps at S={S}: chunk_steps_override={K} bitwise the default "
          f"(costs, steps, params); host reads {a['reads']} default / {b['reads']} at K={K}, "
          f"a tick per read; launches {b['launches']} at L={S}", flush=True)
    return {k: a["launches"][k] + b["launches"][k] for k in ("fwd", "bwd")}


def farm_phase(fp, dev):
    """Phase 7: the flagship seed farm at full width through ``SeedFarm.run``,
    then its chunk control (:func:`farm_chunk_check`); returns its kernel
    launches."""
    from mcpilco_tpu_torch.control.trainer import graph_counts, reset_graph_counts
    from mcpilco_tpu_torch.scenarios import cartpole

    cfg = farm_config()
    reset_graph_counts()
    agent, farm, res, launches = run_farm(fp, dev, cartpole, cfg, range(1, FARM_SEEDS + 1),
                                          kernels=True)
    MESH_INPUTS["farm"] = (res, dict(graph_counts))  # phase 16's one-card farm
    more = farm_chunk_check(farm, fp)
    launches = {k: launches[k] + more[k] for k in launches}
    farm_step_profile(agent, farm, host_steps=2, window=2)
    # the fits sum in another order when batched; 10 BPTT steps stay close
    # (5.77e-05 on the H100, while two seeds' costs differ by ~4e-3)
    farmed_against_alone(cartpole, cfg, farm, res, dev, 10, 1e-3)
    GRAPH_PATHS["farm"] = farm_path(agent, farm)
    return launches


def pms_estimator_check(agent, farm, cfg, dev):
    """The 4PMS farm's exploration trials rolled again from the same keys:
    the device estimator (``offline_velocity_estimation_lanes``) against the
    host ``offline_velocity_estimation`` per seed and column (largest error
    relative to the column's max-abs, at most 1e-5), and the farm's stored
    training pairs equal to the pairs of the device estimate."""
    from mcpilco_tpu_torch.envs.plants import (offline_velocity_estimation,
                                               offline_velocity_estimation_lanes)
    from mcpilco_tpu_torch.utils import prng

    keys = [prng.fold(prng.stream(k, prng.STREAM_SYSTEM), 0) for k in farm.keys]
    x0 = np.stack([farm._sample_x0(k, 0) for k in farm.keys])
    trial = agent.plant.rollout_lanes(keys, x0, agent.exploration_policy, farm.expl_params,
                                      cfg.T_exploration, agent.dt, device=dev)
    opts = dict(pos_indices=agent.model.pos_indices, vel_indices=agent.model.vel_indices,
                filt_cutoff=agent.offline_filter_cutoff, method=agent.offline_filter_method)
    est, inputs = offline_velocity_estimation_lanes(
        torch.as_tensor(trial.noisy, device=dev), torch.as_tensor(trial.inputs, device=dev),
        agent.dt, **opts)
    torch.cuda.synchronize()
    est, inputs = est.cpu().numpy(), inputs.cpu().numpy()
    cols = list(agent.model.pos_indices) + list(agent.model.vel_indices)
    errs = []
    for i in range(len(farm.seeds)):
        host, _ = offline_velocity_estimation(trial.noisy[i], trial.inputs[i], agent.dt, **opts)
        errs.append(np.max(np.abs(est[i] - host)[:, cols], axis=0)
                    / np.max(np.abs(host)[:, cols], axis=0))
        x, y = agent.model.training_pairs(torch.as_tensor(est[i]), torch.as_tensor(inputs[i]))
        n = x.shape[0]
        if not (np.array_equal(farm.gp_x[i, :n], x.numpy())
                and np.array_equal(farm.gp_y[i, :, :n], y.numpy())):
            raise RuntimeError(f"seed {farm.seeds[i]}: the farm's training pairs differ from "
                               f"those of the device estimate")
    errs = np.stack(errs)
    print(f"  4PMS device estimator ({agent.offline_filter_method}) against the host path on "
          f"the farm's {len(farm.seeds)} exploration trials ({trial.noisy.shape[1]} samples): "
          f"largest error per seed over the columns, relative to the column's max-abs "
          f"{errs.max(axis=1).tolist()}; the farm's training pairs are those of the device "
          f"estimate", flush=True)
    if not errs.max() <= 1e-5:
        raise RuntimeError(f"the device estimator left the host path: {errs}")
    return float(errs.max())


def legacy_variance_check(agent, farm, fp, dev):
    """The 4PMS farm's posteriors built on its whole dataset in the factor
    form and under the legacy variance operator, at 400 inputs per seed
    drawn from its data.  ``MultiGP.predict`` on the card launches K1 on the
    factor form and no kernel under the legacy operator (K1/K2 take the
    factor form).  In float64, on the card, the two operators predict the
    same (rtol 1e-6).  In float32 the legacy quad sum((k* K^-1) * k*)
    cancels against the prior variance where F's squared sum does not: both
    float32 predictions are held against the float64 one, the legacy mean
    no less accurate than K1's (within 4x, plus 1e-6), the legacy variance's
    error printed beside the factor form's."""
    from mcpilco_tpu_torch.models import gp as gp_mod
    from mcpilco_tpu_torch.models.gp import GPData, tree_map

    rng = np.random.default_rng(2)
    n = farm.gp_x.shape[1]
    xs = torch.as_tensor(np.stack([x[rng.integers(0, n, 400)] for x in farm.gp_x]), device=dev)
    data = farm._padded_data()
    data64 = GPData(*(t.double() for t in data))
    params64 = tree_map(torch.Tensor.double, farm.gp_params)
    gp = agent.gp
    out = {}
    with torch.no_grad():
        for legacy in (False, True):
            gp_mod.use_legacy_variance_op(legacy)
            try:
                post = farm._build_posterior(data)
                fp.reset_launches()
                mean, var = gp.predict(farm.gp_params, post, xs)
                torch.cuda.synchronize()
                launched = dict(fp.launches)
                m64, v64 = gp._predict_plain(params64, gp.fit_posterior(params64, data64),
                                             xs.double())
                out[legacy] = (mean.double(), var.double(), launched, m64, v64)
            finally:
                gp_mod.use_legacy_variance_op(False)
    (m_f, v_f, factor, m64, v64), (m_l, v_l, legacy, m64_l, v64_l) = out[False], out[True]
    if factor != {"fwd": 1, "bwd": 0} or legacy != {"fwd": 0, "bwd": 0}:
        raise RuntimeError(f"predict launches: factor form {factor}, legacy operator {legacy}")
    torch.testing.assert_close(m64_l, m64, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(v64_l, v64, rtol=1e-6, atol=1e-9)
    errs = {name: (max_err(m, m64), max_err(v, v64))
            for name, m, v in (("K1, factor form", m_f, v_f), ("legacy, plain", m_l, v_l))}
    print(f"  legacy variance operator (K^-1 stored, M={data.x.shape[1]}): predict on the card "
          f"launched {legacy} (factor form {factor}); float64 legacy against float64 factor "
          f"form: max err mean {max_err(m64_l, m64):.3e}, var {max_err(v64_l, v64):.3e}; float32 "
          f"against float64 at {tuple(xs.shape)} (max |mean| {float(m64.abs().max()):.3e}, max "
          f"var {float(v64.max()):.3e}): "
          + " | ".join(f"{k} mean err {e[0]:.3e} var err {e[1]:.3e}" for k, e in errs.items())
          + f"; legacy against factor form, float32: mean {max_err(m_l, m_f):.3e}, var "
          f"{max_err(v_l, v_f):.3e}", flush=True)
    e_k, e_l = errs["K1, factor form"], errs["legacy, plain"]
    if not (all(math.isfinite(e) for e in (*e_k, *e_l)) and e_l[0] <= 4 * e_k[0] + 1e-6):
        raise RuntimeError(f"legacy variance operator on the card: {errs}")
    return errs


class HostODEPlant:
    """The flagship's ODE plant behind a host plant's ``rollout()``
    protocol, not an ``ODEPlant``: the farm collects from it seed by seed
    (``SeedFarm._collect_host``), as from a MuJoCo plant, which the card's
    machine cannot run."""

    def __init__(self, plant):
        self.plant = plant

    def rollout(self, key, s0, policy, policy_params, T, dt, device="cuda"):
        return self.plant.rollout(key, s0, policy, policy_params, T, dt, device=device)


def host_plant_farm(fp, dev):
    """Two flagship seeds, 1 trial of 3 steps, farmed once through the host
    path and once through the device plant: training pairs within 1e-6,
    costs finite.  Returns the host-plant farm's launches."""
    from mcpilco_tpu_torch.scenarios import cartpole

    cfg = cartpole.CartpoleConfig(seed=1, num_trials=1, opt_steps=(3,), gp_epochs=300)
    out = {}
    for host in (True, False):
        _, farm, res, launches = run_farm(fp, dev, cartpole, cfg, (1, 2), kernels=True,
                                          host_plant=host)
        if farm._device_plant == host:
            raise RuntimeError(f"host={host}: the farm took the wrong collection path")
        out[host] = (farm, res, launches)
    (fh, rh, launches), (fd, rd, _) = out[True], out[False]
    err = max(float(np.max(np.abs(fh.gp_x - fd.gp_x))), float(np.max(np.abs(fh.gp_y - fd.gp_y))))
    costs = rh.trial_logs[-1].cost_history
    print(f"  host-plant farm (_collect_host), 2 seeds: training pairs {fh.gp_x.shape} against "
          f"the device plant's, max err {err:.3e}; last costs "
          f"{[round(float(c), 4) for c in costs[:, -1]]} (device plant "
          f"{[round(float(c), 4) for c in rd.trial_logs[-1].cost_history[:, -1]]})", flush=True)
    if not (err <= 1e-6 and np.all(np.isfinite(costs))):
        raise RuntimeError(f"host-plant farm: pairs err {err}, costs {costs}")
    return launches


def farm_scenarios_phase(fp, dev):
    """Phase 14: the seed farm over the other scenarios at full width, depth
    cut.  (a) 4PMS over ``FARM_SEEDS`` seeds (P=400, horizon 90, exact 'se'
    GP, BPTT clip 0.2, 300-epoch fits, 1 trial of 5 steps): K1/K2 with one
    lane per seed, the device estimator against the host path, (e) the
    legacy variance operator on the farm's posteriors, the step profile
    beside one seed's and beside a lane axis of size 1, one seed's curve
    farmed against alone within 5e-3.  (b) Furuta, the shipped
    semiparametric model (plain predict, delta cap 3), 4 seeds, 1 trial of
    3 steps: no launch, the step profile, farmed against alone.  (c) the
    host-plant path.  (d) ``repeat --scenario cartpole_pms --farm``.
    Returns the launches of the farms' main paths ((a), (c), (d)) and the
    4PMS farm's launches with its optimizer steps."""
    import os

    from mcpilco_tpu_torch.scenarios import cartpole_pms, furuta
    from mcpilco_tpu_torch.scripts import repeat

    counted = []
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        print(f"  ({name}) done in {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()

    print("  (a) 4PMS:", flush=True)
    # depth cut to make room for phase 16: 300-epoch fits (500), profiled
    # windows of 1 step (2)
    cfg = cartpole_pms.CartpolePMSConfig(seed=1, num_trials=1, opt_steps=(5,), gp_epochs=300)
    agent, farm, res, launches = run_farm(fp, dev, cartpole_pms, cfg, range(1, FARM_SEEDS + 1),
                                          kernels=True)
    counted.append(launches)
    pms = dict(launches=launches, optimizer_steps=int(res.trial_logs[0].steps_done.max()))
    pms_estimator_check(agent, farm, cfg, dev)
    legacy_variance_check(agent, farm, fp, dev)
    farm_step_profile(agent, farm, host_steps=2, window=1, lane_one=True)
    # the sensor chain has gain 1/dt = 30: the CPU test's tolerance
    farmed_against_alone(cartpole_pms, cfg, farm, res, dev, 5, 5e-3)
    del agent, farm, res
    part("a")

    print("  (b) Furuta, semiparametric:", flush=True)
    # the farmed-against-alone check needs the 500-epoch fit: at 300 epochs
    # the two curves spread 1.1e-2 apart (H100)
    cfg = furuta.FurutaConfig(seed=1, num_trials=1, opt_steps=(3,), gp_epochs=500)
    agent, farm, res, _ = run_farm(fp, dev, furuta, cfg, range(1, FARM_SEEDS + 1), kernels=False)
    if FULL_PROFILE:
        farm_step_profile(agent, farm, host_steps=2, window=2)
    farmed_against_alone(furuta, cfg, farm, res, dev, 3, 5e-3)
    del agent, farm, res
    part("b")

    print("  (c) the host-plant path:", flush=True)
    counted.append(host_plant_farm(fp, dev))
    part("c")

    print("  (d) repeat --scenario cartpole_pms --farm:", flush=True)
    summary_path = os.path.join("results_tmp", "torch", "repeat_cartpole_pms_chip_smoke.json")
    if os.path.exists(summary_path):
        os.remove(summary_path)
    fp.reset_launches()
    rc = repeat.main(["--scenario", "cartpole_pms", "--farm", "--num-seeds", "2", "--trials", "1",
                      "--device", str(dev), "--out-tag", "chip_smoke",
                      "--scenario-kw", "opt_steps=(3,)", "--scenario-kw", "gp_epochs=300"])
    torch.cuda.synchronize()
    counted.append(dict(fp.launches))
    with open(summary_path) as f:
        summary = json.load(f)
    seed_costs = list(summary["per_seed_cost"].values())
    if rc != 0 or summary["seeds"] != [1, 2] or not summary["complete"] or not all(
            c is not None and math.isfinite(c) for c in seed_costs) or \
            fp.launches["fwd"] == 0 or fp.launched_lanes["fwd"] != 2 * fp.launches["fwd"]:
        raise RuntimeError(f"repeat --farm cartpole_pms: rc {rc}, summary {summary}, launches "
                           f"{fp.launches}, lanes {fp.launched_lanes}")
    print(f"  repeat --farm cartpole_pms, 2 seeds: costs {seed_costs}, success rate "
          f"{summary['success_rate']}, launches {counted[-1]}", flush=True)
    part("d")
    return {k: sum(c[k] for c in counted) for k in ("fwd", "bwd")}, pms


def restart_phase(fp, dev):
    """Phase 8: a 1-trial 4PMS ``reinforce`` with two restart lanes."""
    from mcpilco_tpu_torch.scenarios import cartpole_pms

    cfg = cartpole_pms.CartpolePMSConfig(seed=1, num_trials=1, opt_steps=(3,), num_restarts=2,
                                         gp_epochs=500)
    agent, kwargs = cartpole_pms.build(cfg, dev)
    launches = main_path((agent, kwargs), fp)
    log = agent.trial_logs[-1]
    costs = log.restart_costs
    if costs is None or costs.shape != (2,) or not np.all(np.isfinite(costs)) or \
            log.restart_winner != int(np.argmin(costs)):
        raise RuntimeError(f"restart lanes: costs {costs}, winner {log.restart_winner}")
    print(f"  restart lanes' best costs {costs.round(4).tolist()}, winner lane "
          f"{log.restart_winner}; particles per launch {2 * agent.optimizer.num_particles} "
          f"(the lanes share the posterior and fold into one K1/K2 call)", flush=True)
    return launches


def sor_phase(fp, dev):
    """Phase 11: the flagship cart-pole ``reinforce`` with the SOD posterior
    replaced by SOR (wired as tests/test_sor.py wires it): relative
    threshold 0.5 (the flagship SOD's), 200 refinement epochs with trained
    inducing inputs; returns its launches (none: SOR has no kernel)."""
    from mcpilco_tpu_torch.models.sod import SORConfig
    from mcpilco_tpu_torch.scenarios import cartpole

    cfg = cartpole.CartpoleConfig(seed=1, num_trials=1, opt_steps=(10,), gp_epochs=500)
    agent, kwargs = cartpole.build(cfg, dev)
    agent.sod = None
    agent.sor = SORConfig(threshold_mode="relative", threshold=(0.5,), refine_epochs=200,
                          train_inducing=True)
    agent.gp = dataclasses.replace(agent.gp, approx="sor")
    agent.optimizer = dataclasses.replace(
        agent.optimizer, engine=dataclasses.replace(agent.optimizer.engine, gp=agent.gp))
    infos, fit = [], agent.fit_model
    agent.fit_model = lambda opts: infos.append(fit(opts)) or infos[-1]
    launches = main_path((agent, kwargs), fp)
    info, log = infos[-1], agent.trial_logs[-1]
    if not ("sor_points" in info and math.isfinite(info["sor_mll_last"])
            and info["sor_mll_last"] <= info["sor_mll_first"]):
        raise RuntimeError(f"SOR refinement: {info}")
    if agent.posterior.x_tr.dim() != 3:
        raise RuntimeError(f"trained inducing inputs should be per head, got "
                           f"{tuple(agent.posterior.x_tr.shape)}")
    print(f"  SOR: N={info['num_samples']}, inducing points {info['sor_points']} of "
          f"{agent.posterior.x_tr.shape[1]} (per head, trained), SOR MLL "
          f"{info['sor_mll_first']:.2f} -> {info['sor_mll_last']:.2f}; fit + selection + "
          f"refinement {info['wall_clock_s']:.2f} s; {log.steps_done} steps at "
          f"{1e3 * log.wall_clock_s / log.steps_done:.2f} ms/step", flush=True)
    return launches


def same_tree(a, b):
    """Two trees of tensors (or arrays) equal leaf by leaf, bitwise, by name."""
    from mcpilco_tpu_torch.utils.checkpoint import flatten_with_path

    na, nb = dict(flatten_with_path(a)), dict(flatten_with_path(b))
    return na.keys() == nb.keys() and all(
        torch.equal(torch.as_tensor(na[k]).cpu(), torch.as_tensor(nb[k]).cpu()) for k in na)


def same_logs(a, b):
    fields = ("cost_history", "std_history", "particles_states", "particles_inputs")
    return len(a) == len(b) and all(
        all(np.array_equal(getattr(x, f), getattr(y, f)) for f in fields)
        and (x.steps_done, x.reinit_count, x.wall_clock_s) ==
        (y.steps_done, y.reinit_count, y.wall_clock_s) for x, y in zip(a, b))


def entry_points_phase(fp, dev):
    """Phase 12: the user's entry points at full flagship width (depth cut to
    5 optimizer steps per trial and 300-epoch fits), with checkpoints under
    the ignored ``results_tmp/``.  (a) ``build`` + ``reinforce`` of 2 of the
    config's 3 trials, a run interrupted after trial 1; every stage
    checkpoint loaded on a fresh agent, its arrays held bitwise against the
    run's and its rebuilt posterior's K1 predictions against the run's at
    FWD_TOL.  (b) ``train_cartpole.run(cfg, auto_resume=True)``: 2 trials
    resumed, trial 2 trained; the gap to the unbroken run's trial 2.  (c)
    ``apply_policy`` on ``complete_trial1``, on the plant (5 runs) and on the
    model (400 particles x 60 steps).  (d) ``repeat --farm`` over 2 seeds.
    (e) ``repeat --jobs 2`` over 2 seeds at full width as subprocesses,
    1 trial of 5 steps each and 300-epoch fits.  Returns
    the K1/K2 launches of (a)-(d)."""
    import os
    import shutil

    from mcpilco_tpu_torch.scenarios import cartpole
    from mcpilco_tpu_torch.scripts import apply_policy, repeat, train_cartpole

    root = os.path.join("results_tmp", "torch")
    log_dir = os.path.join(root, "chip_smoke_run")
    summary_path = os.path.join(root, "repeat_cartpole_chip_smoke.json")
    shutil.rmtree(log_dir, ignore_errors=True)
    if os.path.exists(summary_path):
        os.remove(summary_path)
    cfg = cartpole.CartpoleConfig(seed=1, num_trials=3, opt_steps=(5,), gp_epochs=300,
                                  log_dir=log_dir)
    counted = []

    def count(what):
        torch.cuda.synchronize()
        got = dict(fp.launches)
        if got["fwd"] == 0 or (what != "c" and got["bwd"] == 0):
            raise RuntimeError(f"phase 12 ({what}) did not launch K1/K2: {got}")
        counted.append(got)
        print(f"  ({what}) launches {got}", flush=True)

    # (a) the interrupted run, each checkpoint's save timed
    agent, kwargs = cartpole.build(cfg, dev)
    saves, save = {}, agent.save_checkpoint

    def timed_save(stage):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(stage)
        saves[stage] = time.perf_counter() - t

    agent.save_checkpoint = timed_save
    fp.reset_launches()
    reserved = []
    agent.reinforce(**{**kwargs, "num_trials": 2},
                    on_trial_end=lambda a, t: reserved.append(torch.cuda.memory_reserved(dev)))
    count("a")
    # each trial's graphed optimize frees its graph and memory pool; a pool
    # left behind would add the flagship step's activations (~0.1-1 GB)
    print(f"  reserved memory after each trial: {reserved} bytes", flush=True)
    if reserved[-1] > reserved[0] + 32 * 2**20:
        raise RuntimeError(f"reserved memory grew from trial to trial: {reserved}")
    stages = [f"{s}_trial{i}" for i in (0, 1) for s in ("model", "policy", "complete")]
    if sorted(saves) != sorted(stages) or not all(
            os.path.isdir(os.path.join(log_dir, s)) for s in stages):
        raise RuntimeError(f"stage checkpoints {sorted(os.listdir(log_dir))}, saved {saves}")
    fresh = cartpole.build(cfg, dev)[0]
    for st in stages:
        path = os.path.join(log_dir, st)
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t = time.perf_counter()
        fresh.load_checkpoint(path)
        torch.cuda.synchronize()
        print(f"  checkpoint {st}: {size} bytes, save {saves[st]:.4f} s, load + posterior "
              f"rebuild {time.perf_counter() - t:.4f} s", flush=True)
    # fresh now holds complete_trial1, the state (a) ended in
    if not (same_tree(fresh.gp_params, agent.gp_params)
            and same_tree(fresh.policy_params, agent.policy_params)
            and np.array_equal(fresh.gp_x, agent.gp_x) and np.array_equal(fresh.gp_y, agent.gp_y)
            and same_logs(fresh.trial_logs, agent.trial_logs)
            and fresh.num_collections == agent.num_collections == 3):
        raise RuntimeError("the restored state differs from the run's")
    x = torch.as_tensor(agent.gp_x, device=dev)
    with torch.no_grad():
        fp.reset_launches()
        m_r, v_r = fresh.gp.predict(fresh.gp_params, fresh.posterior, x)
        post = agent._build_posterior(agent._padded_data())
        m_a, v_a = agent.gp.predict(agent.gp_params, post, x)
    torch.cuda.synchronize()
    if fp.launches["fwd"] != 2:
        raise RuntimeError(f"the restored posterior's predict did not run K1: {fp.launches}")
    torch.testing.assert_close(m_r, m_a, **FWD_TOL)
    torch.testing.assert_close(v_r, v_a, **FWD_TOL)
    print(f"  restored gp_params, policy params, dataset and trial logs bitwise equal to the "
          f"run's; K1 on the rebuilt posterior (M={fresh.posterior.x_tr.shape[0]}) at the "
          f"N={x.shape[0]} dataset inputs against the run's: max err mean "
          f"{max_err(m_r, m_a):.3e}, var {max_err(v_r, v_a):.3e}", flush=True)

    # (b) the resume, through the train script
    fp.reset_launches()
    resumed, done = train_cartpole.run(cfg, dev, auto_resume=True)
    count("b")
    if done != 2 or len(resumed.trial_logs) != 3 or not same_logs(
            resumed.trial_logs[:2], agent.trial_logs) or not os.path.isdir(
            os.path.join(log_dir, "complete_trial2")):
        raise RuntimeError(f"resume: {done} trials resumed, {len(resumed.trial_logs)} logs")
    agent.log_dir = None  # the unbroken run's trial 2, for the gap only
    agent.reinforce(**{**kwargs, "num_trials": 1}, verbose=False)
    a, b = agent.trial_logs[2].cost_history, resumed.trial_logs[2].cost_history
    print(f"  resumed 2 trials, trained trial 2; its costs against the unbroken run's: largest "
          f"gap {float(np.max(np.abs(a - b) / np.abs(a))):.2e} relative "
          f"({len(b)} steps, last {b[-1]:.4f} / {a[-1]:.4f})", flush=True)

    # (c) replay of complete_trial1
    fp.reset_launches()
    rep = apply_policy.load_agent(os.path.join(log_dir, "complete_trial1"), dev)
    costs = apply_policy.replay_system(rep, 5, 3.0)
    total, spread, states = apply_policy.replay_model(rep, 400, 3.0)
    count("c")
    if not (np.all(np.isfinite(costs)) and math.isfinite(total) and math.isfinite(spread)
            and states.shape == (60, 400, 4) and np.all(np.isfinite(states))):
        raise RuntimeError(f"replay: system costs {costs}, model cost {total} +- {spread}")
    print(f"  replay on the plant, 5 runs: cost {np.mean(costs):.4f} +- {np.std(costs):.4f}; "
          f"on the model, 400 particles x 60 steps: cost {total:.4f} (particle std "
          f"{spread:.4f})", flush=True)

    # (d) the farmed sweep
    fp.reset_launches()
    rc = repeat.main(["--scenario", "cartpole", "--farm", "--num-seeds", "2", "--device", str(dev),
                      "--out-tag", "chip_smoke", "--scenario-kw", "num_trials=1",
                      "--scenario-kw", "opt_steps=(5,)", "--scenario-kw", "gp_epochs=300"])
    count("d")
    with open(summary_path) as f:
        summary = json.load(f)
    seed_costs = list(summary["per_seed_cost"].values())
    if rc != 0 or summary["seeds"] != [1, 2] or not all(
            c is not None and math.isfinite(c) for c in seed_costs) or \
            fp.launched_lanes["fwd"] != 2 * fp.launches["fwd"]:
        raise RuntimeError(f"repeat --farm: rc {rc}, summary {summary}, lanes "
                           f"{fp.launched_lanes}")
    print(f"  repeat --farm, 2 seeds: costs {seed_costs}, success rate "
          f"{summary['success_rate']}", flush=True)

    # (e) subprocess seeds, two at once on the card (their launches are the
    # children's)
    t = time.perf_counter()
    cut = ["--opt-steps=5", "--gp-epochs=300"]
    rc = repeat.main(["--scenario", "cartpole", "--no-farm", "--jobs", "2", "--trials", "1",
                      "--num-seeds", "2", "--device", str(dev), "--out-tag", JOBS_TAG]
                     + [f"--extra-flag={f}" for f in cut])
    jobs_s = time.perf_counter() - t
    with open(os.path.join(root, f"repeat_cartpole_{JOBS_TAG}.json")) as f:
        summary = json.load(f)
    logs = [os.path.join(root, f"cartpole_{JOBS_TAG}_{s}", "stdout.log") for s in (1, 2)]
    if rc != 0 or summary["seeds"] != [1, 2] or summary["infra_error_seeds"] or not all(
            c is not None and math.isfinite(c) for c in summary["per_seed_cost"].values()) or \
            summary["extra_flags"] != cut or summary["trials"] != 1 or summary["smoke"] or \
            not all(map(os.path.isfile, logs)):
        raise RuntimeError(f"repeat --jobs 2: rc {rc}, summary {summary}")
    print(f"  repeat --jobs 2, 2 full-width seed subprocesses on the card: costs "
          f"{summary['per_seed_cost']}, success rate {summary['success_rate']}, "
          f"{jobs_s:.1f} s", flush=True)
    return {k: sum(c[k] for c in counted) for k in ("fwd", "bwd")}


def summarize_phase():
    """Phase 12 (f), after phase 14: ``summarize_results --json`` over the
    summaries of phase 12 (d), (e) and phase 14 (d) as the port's, beside
    the JAX package's records in ``results/``: a row for each of the three,
    and the JAX flagship's."""
    import io
    import os

    from mcpilco_tpu_torch.scripts import summarize_results

    # each summary's row: its scenario and arm
    expect = {"cartpole_chip_smoke": "cartpole [num_trials=1 opt_steps=(5,) gp_epochs=300]",
              f"cartpole_{JOBS_TAG}": "cartpole [--trials=1 --opt-steps=5 --gp-epochs=300]",
              "cartpole_pms_chip_smoke": "cartpole_pms [--trials=1 opt_steps=(3,) gp_epochs=300]"}
    files = {name: os.path.join("results_tmp", "torch", f"repeat_{name}.json") for name in expect}
    files = {name: path for name, path in files.items() if os.path.exists(path)}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = summarize_results.main(["--json"] + [a for f in files.values() for a in ("--dir", f)])
    rows = json.loads(out.getvalue())
    mine = sorted(r["scenario"] for r in rows if r["package"] == "torch")
    if rc != 0 or len(files) < 2 or mine != sorted(expect[name] for name in files) or not any(
            r["package"] == "jax" and r["scenario"] == "cartpole" for r in rows):
        raise RuntimeError(f"summarize_results over {list(files.values())}: rc {rc}, rows {rows}")
    for r in rows:
        if r["package"] == "torch" or r["scenario"] == "cartpole":
            q = r["cost_quartiles"]
            print(f"  {r['package']:5s} {r['scenario']}: {r['successes']}/{r['seeds']}, cost "
                  f"quartiles {q and (q['q25'], q['median'], q['q75'])}", flush=True)


def ur5_fitted(cfg, trials, fp, dev):
    """``ur5.build`` at full width, the recorded trials in through
    ``add_external_trial``, the config's fit; N, the SOD counts per head and
    M printed, the fitted posterior held against float64."""
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.scenarios import ur5

    agent, _ = ur5.build(cfg, dev)
    for measured, inputs in zip(trials["measured"], trials["inputs"]):
        agent.add_external_trial(measured, inputs, exploration=True)
    t0 = time.perf_counter()
    info = agent.fit_model(ModelFitOptions(num_epochs=cfg.gp_epochs))
    torch.cuda.synchronize()
    M = agent.posterior.x_tr.shape[0]
    print(f"  UR5 poly_degree={cfg.poly_degree}: N={info['num_samples']} sod per head "
          f"{info['sod_points']} M={M}; mll {info['mll_first']:.1f} -> {info['mll_last']:.1f} "
          f"over {cfg.gp_epochs} epochs; fit + posterior {time.perf_counter() - t0:.2f} s; "
          f"one-step MSE {agent.one_step_mse()}", flush=True)
    if info["num_samples"] != 400 or M != 448:
        raise RuntimeError(f"UR5 from the recorded trials: N={info['num_samples']}, M={M}; "
                           f"expected N=400, M=448")
    check_real_posterior(agent.gp, agent.gp_params, agent.posterior, agent.gp_x, dev)
    return agent


def ur5_step_profile(agent, fp, label):
    """``UR5_STEPS`` timed optimizer steps, with ``FULL_PROFILE`` as the host
    window of the step profile; the costs finite, the kernels launched where
    the structure has them."""
    from mcpilco_tpu_torch.utils import prng
    from mcpilco_tpu_torch.utils.profiling import GRAPH_BASE, host_ms, profile_steps

    runs = {}

    def run(n):
        runs[n] = agent.optimizer.optimize(prng.fold(prng.root_key(7), 1), agent.policy_params,
                                           agent.gp_params, agent.posterior, n, 0.01, 0.25)
        torch.cuda.synchronize()

    fp.reset_launches()
    if FULL_PROFILE:
        p = profile_steps(run, host_steps=UR5_STEPS, window=2)
    else:
        p = dict(host_ms=host_ms(run, UR5_STEPS)[0])
    res = runs[GRAPH_BASE + UR5_STEPS]
    costs = res.cost_history[: res.steps_done].numpy()
    if res.steps_done != GRAPH_BASE + UR5_STEPS or not np.all(np.isfinite(costs)):
        raise RuntimeError(f"UR5 {label}: {res.steps_done} steps, costs {costs}")
    kernels = agent.gp._fused_structure() is not None
    if (min(fp.launches.values()) > 0) != kernels or (max(fp.launches.values()) > 0) != kernels:
        raise RuntimeError(f"UR5 {label}: launches {fp.launches} against the kernel structure "
                           f"{agent.gp._fused_structure()}")
    profiled = ""
    if FULL_PROFILE:
        top = ", ".join(f"{k[:40]} {v:.0f}" for k, v in list(p["events_by_kernel"].items())[:4])
        profiled = (f", device busy {p['busy_ms']:.2f} ms/step, device events per step "
                    f"{p['events']:.0f}, idle share {p['idle']:.3f}; most events per step: {top}")
    print(f"  UR5 {label}, P={agent.optimizer.num_particles}, horizon {agent.optimizer.horizon}, "
          f"remat: {p['host_ms']:.2f} host ms/step; cost {costs[0]:.3f} -> {costs[-1]:.3f}"
          f"{profiled}", flush=True)
    return p


def ur5_remat_check(agent, dev):
    """One rollout's policy gradient from one key with remat on and off:
    bitwise equal, or the largest difference stated (and held within
    GRAD_TOL); the peak memory of each."""
    from mcpilco_tpu_torch.utils import prng

    out = {}
    for remat in (True, False):
        opt = dataclasses.replace(agent.optimizer, engine=dataclasses.replace(
            agent.optimizer.engine, remat=remat))
        leaves = {k: v[None].detach().clone().requires_grad_(True)
                  for k, v in agent.policy_params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        cost, _ = opt._rollout_cost(leaves, agent.gp_params, agent.posterior,
                                    [prng.fold(prng.root_key(7), 3)], 0.25, 0)
        grads = torch.autograd.grad(cost.sum(), list(leaves.values()))
        torch.cuda.synchronize()
        out[remat] = (cost.detach(), [g.detach() for g in grads],
                      torch.cuda.max_memory_allocated(dev), base, time.perf_counter() - t0)
    (c1, g1, peak1, base1, s1), (c0, g0, peak0, base0, s0) = out[True], out[False]
    equal = torch.equal(c1, c0) and all(torch.equal(a, b) for a, b in zip(g1, g0))
    diff = max(max_err(a, b) / max(float(b.abs().max()), 1e-30) for a, b in zip(g1, g0))
    same = "bitwise equal" if equal else f"largest relative difference {diff:.3e}"
    print(f"  UR5 remat on / off, one rollout + backward from one key: cost {float(c1):.6f} / "
          f"{float(c0):.6f}; gradients {same}; "
          f"peak memory {peak1 / 2**30:.3f} / {peak0 / 2**30:.3f} GiB (above {base1 / 2**30:.3f} "
          f"GiB held before); {s1:.2f} / {s0:.2f} s", flush=True)
    if not all(float(g.abs().max()) > 0 for g in g0):
        raise RuntimeError("UR5 remat check: a zero policy gradient compares nothing")
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    return dict(peak_remat=peak1, peak_plain=peak0, bitwise=equal)


def ur5_kernel_times(agent, fp, dev):
    """K1 and K2 on the fitted 'se+p2' posterior at the rollout's P=200,
    device us per launch (x* drawn from the dataset inputs), beside the plain
    versions' call."""
    rng = np.random.default_rng(1)
    xs0 = torch.as_tensor(agent.gp_x[rng.integers(0, len(agent.gp_x), 200)], device=dev)
    gp, params, post = agent.gp, agent.gp_params, agent.posterior
    wk, wq = cotangents(200, dev, gp.num_heads)

    def fwd_bwd(fn):
        xs = xs0.clone().requires_grad_(True)
        mean, var = fn(params, post, xs)
        return torch.autograd.grad(torch.sum(wk * mean) + torch.sum(wq * var), xs)

    per = {name: device_us(lambda: fwd_bwd(fn))
           for name, fn in (("kernel", gp._predict_fused), ("plain", gp._predict_plain))}
    t = dict(k1=k1_us(per["kernel"]), gen=named_us(per["kernel"], "k1_gen"),
             k2=named_us(per["kernel"], "k2_backward_xstar"),
             call=sum(per["kernel"].values()), plain=sum(per["plain"].values()))
    print(f"  UR5 fitted posterior (se+p2 D=24 G=6 P=200 M={post.x_tr.shape[0]}), device us per "
          f"predict fwd+bwd: K1 {t['k1']:.2f} (its generation pass {t['gen']:.2f}), K2 "
          f"{t['k2']:.2f} (the call {t['call']:.2f}; "
          f"_predict_plain {t['plain']:.2f})", flush=True)
    return t


def ur5_phase(fp, dev):
    """Phase 13: UR5 on the card from the recorded trials (the card's machine
    has no ``mujoco``: the MuJoCo plant is built and never rolled out).
    The default Sum(SE, MPK1) model (the plain predict): fit, float64 check,
    step profile, remat on/off; then ``poly_degree=2`` on the same trials
    (K1/K2 in their wide path at D=24 G=6 P=200 M=448) with the per-trial
    cost curriculum: fit, float64 check, step profile, K1/K2 on the fitted
    posterior; then the HIL main path: ``improve_policy`` of ``UR5_STEPS`` steps (the
    kernel side of the learning curve, held against the same steps
    through ``_predict_plain``), ``export_policy_csv`` and a checkpoint
    round trip.  Returns the main path's launches and the
    real-posterior kernel times."""
    import os
    import shutil

    from mcpilco_tpu_torch.control.mc_pilco import PolicyOptOptions
    from mcpilco_tpu_torch.scenarios import ur5
    from mcpilco_tpu_torch.utils import prng

    trials = ur5.recorded_trials()
    cfg = ur5.UR5Config(seed=1, gp_epochs=UR5_EPOCHS)
    agent = ur5_fitted(cfg, trials, fp, dev)
    if agent.gp._fused_structure() is not None:
        raise RuntimeError("UR5's default Sum(SE, MPK1) should have no fused structure")
    ur5_remat_check(agent, dev)
    # its K per read against one is phase 15's
    GRAPH_PATHS["ur5"] = agent_path(agent)
    del agent

    # the fixed cost leaves this seed's init on the saturated plateau (the
    # default model's cost above goes to 199 of a possible 199, where the
    # gradient is 0, and so would the learning curve): the K1/K2 model runs
    # with the cost curriculum, the configuration train_ur5's plateau rescue
    # restarts such a seed with
    cfg2 = dataclasses.replace(cfg, poly_degree=2, cost_lengthscales="curriculum")
    agent = ur5_fitted(cfg2, trials, fp, dev)
    if agent.gp._fused_structure() != "se+p2":
        raise RuntimeError(f"UR5 poly_degree=2 structure {agent.gp._fused_structure()}")
    ur5_step_profile(agent, fp, "se+p2, K1/K2")
    times = ur5_kernel_times(agent, fp, dev)

    # the HIL main path, counted; its steps are the kernel side of the
    # learning curve, the same steps through _predict_plain the other
    log_dir = os.path.join("results_tmp", "torch", "chip_smoke_ur5")
    shutil.rmtree(log_dir, ignore_errors=True)
    agent.log_dir = log_dir
    os.makedirs(log_dir)
    params0 = agent.policy_params
    fp.reset_launches()
    t0 = time.perf_counter()
    log = agent.improve_policy(PolicyOptOptions(opt_steps=UR5_STEPS, learning_rate=0.01,
                                                p_dropout=0.25), trial_index=0)
    csvs = agent.export_policy_csv()
    agent.save_checkpoint("policy_trial0")
    fresh = ur5.build(cfg2, dev)[0]
    fresh.load_checkpoint(os.path.join(log_dir, "policy_trial0"))
    torch.cuda.synchronize()
    launches = dict(fp.launches, **fp.gen_launches)
    hil_s = time.perf_counter() - t0
    if launches["fwd"] == 0 or launches["bwd"] == 0 or launches["gen"] != launches["fwd"]:
        raise RuntimeError(f"the UR5 HIL path did not launch K1 (with its generation pass) "
                           f"and K2: {launches}")
    if log.steps_done != UR5_STEPS or not np.all(np.isfinite(log.cost_history)):
        raise RuntimeError(f"UR5 improve_policy: {log.steps_done} steps, {log.cost_history}")
    if not (same_tree(fresh.policy_params, agent.policy_params)
            and same_tree(fresh.gp_params, agent.gp_params)
            and same_tree(fresh.expl_params, agent.expl_params)
            and np.array_equal(fresh.gp_x, agent.gp_x) and np.array_equal(fresh.gp_y, agent.gp_y)
            and same_logs(fresh.trial_logs, agent.trial_logs)
            and fresh.num_exploration_trials == agent.num_exploration_trials == 2):
        raise RuntimeError("the restored UR5 state differs from the run's")
    for path in csvs:
        name = os.path.basename(path)[len("policy_"):-len(".csv")]
        want = agent.policy_params[name].cpu().numpy()
        if not np.array_equal(np.loadtxt(path, delimiter=",", ndmin=2).astype(np.float32),
                              np.atleast_2d(want)):
            raise RuntimeError(f"exported {path} differs from the policy's {name}")
    plain = learning_run(agent, fp, "plain",
                         prng.fold(prng.stream(agent.key, prng.STREAM_ROLLOUT), 0), params0,
                         UR5_STEPS)
    compare_curves({"kernel": log.cost_history, "plain": plain}, UR5_STEPS)
    print(f"  UR5 HIL path: improve_policy {log.steps_done} steps, cost "
          f"{log.cost_history[0]:.3f} -> {log.cost_history[-1]:.3f}, "
          f"{1e3 * log.wall_clock_s / log.steps_done:.2f} ms/step, reinits {log.reinit_count}; "
          f"{len(csvs)} policy CSVs equal to the params; checkpoint restored bitwise; "
          f"launches {launches} ({launches['fwd'] / log.steps_done:.1f} K1 and "
          f"{launches['bwd'] / log.steps_done:.1f} K2 per step); {hil_s:.1f} s", flush=True)
    return launches, times


# The fitted optimizer paths of phases 3, 5, 7, 9 and 13 by name, which
# phase 15 holds chunked against one host read per iteration (it fits its
# own where a phase did not run): each ``step(n, graph, salt, chunk)`` runs
# n optimizer steps from the key folded with ``salt`` and returns (costs,
# final policy params); ``step.agent`` is the path's agent.
GRAPH_PATHS = {}
# phase 15's depth per path: host steps per window (a chunk of that many
# replays), profiled steps, learning curve steps; a Furuta step takes ~0.1 s
# and a UR5 step ~0.2 s graphed, ~1 s and ~2 s uncaptured (the flagship's
# alone runs uncaptured), and their windows hold ~45K and ~67K kernel
# records per step
GRAPH_DEPTH = {"flagship": (10, 2, 10), "4pms": (10, 2, 10), "farm": (10, 2, 10),
               "furuta": (4, 1, 3), "ur5": (3, 1, 3)}
# phase 15's five paths and what each is
GRAPH_LABELS = {"flagship": "flagship, P=400 (phase 3)", "4pms": "4PMS, M=448 (phase 5)",
                "farm": f"flagship farm, S={FARM_SEEDS} (phase 7)",
                "furuta": "Furuta semiparametric, plain predict (phase 9)",
                "ur5": "UR5 Sum(SE, MPK1), remat (phase 13)"}
# phase 15's profiled modes per path; the other paths and modes run their
# learning curves only (``--full-profile``: every mode of every path)
GRAPH_PROFILED = {"flagship": ["chunked", "chunk=1"]}
# phase 15's modes: (graph, chunk); "chunked" is what every other phase runs
CHUNK_MODES = {"chunked": (True, None), "chunk=1": (True, 1), "uncaptured": (False, None)}


def agent_path(agent):
    """One agent's optimizer as a phase-15 path."""
    from mcpilco_tpu_torch.utils import prng

    def step(n, graph, salt=1, chunk=None):
        res = agent.optimizer.optimize(prng.fold(prng.root_key(7), salt), agent.policy_params,
                                       agent.gp_params, agent.posterior, n, 0.01, 0.25,
                                       graph=graph, chunk=chunk)
        torch.cuda.synchronize()
        return res.cost_history[: res.steps_done].numpy(), res.policy_params
    step.agent = agent
    return step


def farm_path(agent, farm):
    """A farm's lane-batched optimizer over its last posteriors as a
    phase-15 path; costs [S, n], params with the lane axis."""
    from mcpilco_tpu_torch.utils import prng

    def step(n, graph, salt=1, chunk=None):
        keys = [prng.fold(prng.stream(k, prng.STREAM_ROLLOUT), salt) for k in farm.keys]
        results, _ = agent.optimizer.optimize_lanes(keys, farm.policy_params, farm.gp_params,
                                                    farm.posterior, n, 0.01, 0.25, 1,
                                                    graph=graph, chunk=chunk)
        torch.cuda.synchronize()
        return (np.stack([r.cost_history[: r.steps_done].numpy() for r in results]),
                {k: torch.stack([r.policy_params[k] for r in results])
                 for k in results[0].policy_params})
    step.agent = agent
    return step


def fit_graph_path(name, fp, dev):
    """A phase-15 path whose phase did not run: the phase's build and data,
    a shorter fit."""
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.scenarios import cartpole, cartpole_pms, furuta, ur5

    if name == "farm":
        # opt_steps caps every run of the farm's optimizer: phase 7's 10
        cfg = cartpole.CartpoleConfig(seed=1, num_trials=1, opt_steps=(10,), gp_epochs=500)
        agent, farm, _, _ = run_farm(fp, dev, cartpole, cfg, range(1, FARM_SEEDS + 1),
                                     kernels=True)
        return farm_path(agent, farm)
    if name == "ur5":
        return agent_path(ur5_fitted(ur5.UR5Config(seed=1, gp_epochs=500), ur5.recorded_trials(),
                                     fp, dev))
    scen, cfg, trials = {"flagship": (cartpole, cartpole.CartpoleConfig(seed=1), 6),
                         "4pms": (cartpole_pms, cartpole_pms.CartpolePMSConfig(seed=1), 5),
                         "furuta": (furuta, furuta.FurutaConfig(seed=1), 2)}[name]
    agent = scen.build(cfg, dev)[0]
    for i in range(trials):
        agent.collect(cfg.T_exploration, trial_index=i, exploration=True)
    agent.fit_model(ModelFitOptions(num_epochs=500))
    return agent_path(agent)


def graph_ab(name, step, fp, host_steps, window, curve_steps, modes, profiled):
    """One path's step captured as a CUDA graph and run K iterations per
    host read (the default, "chunked") against one read per iteration
    ("chunk=1"), and where ``modes`` holds "uncaptured" against the same
    body uncaptured (``graph=False``).  For each mode in ``profiled``: host
    ms/step in turns (each mode, then back in reverse), device busy, the
    device's idle time inside one replay, device events and host CUDA API
    calls per step, idle share, K1/K2 per step.  From a ``curve_steps``
    learning curve from one key in each mode (uncaptured twice): the
    capture's seconds, the host reads per call and the iterations run after
    every lane stopped.  Fails unless the chunked curve and final params are
    bitwise those of chunk=1 (the uncaptured ones: within the two uncaptured
    runs' spread or 1e-5 relative), the device events per step of the
    profiled modes agree within 0.4% (the profiler's spread between windows
    of the same code; on a disagreement all are profiled once more, since a
    window of ~10^5 records can come back short; ``profile_steps`` itself
    profiles again a pair of windows that evidently lost records, and the
    row lists what it refused), and K1/K2 are counted alike.  Returns the
    row."""
    from mcpilco_tpu_torch.control import trainer
    from mcpilco_tpu_torch.utils.profiling import GRAPH_BASE, host_ms, profile_steps

    runner = lambda m: lambda n: step(n, CHUNK_MODES[m][0], 1, CHUNK_MODES[m][1])
    base = lambda m: GRAPH_BASE if CHUNK_MODES[m][0] else 1
    prof, host = {}, {m: [] for m in profiled}
    for turn in range(2):
        for m in (profiled if turn % 2 == 0 else profiled[::-1]):
            if m in prof:
                host[m] += host_ms(runner(m), host_steps, base(m))
            else:
                prof[m] = profile_steps(runner(m), host_steps=host_steps, window=window,
                                        base=base(m))
                host[m].append(prof[m]["host_ms"])
    events = lambda: [prof[m]["events"] for m in profiled]
    spread = lambda: len(profiled) > 1 and max(events()) - min(events()) > 0.004 * min(events())
    if spread():
        print(f"  graph {name}: device events per step {events()} ({profiled}); profiling all "
              f"again", flush=True)
        for m in profiled:
            prof[m] = profile_steps(runner(m), host_steps=host_steps, window=window, base=base(m))
            host[m].append(prof[m]["host_ms"])
    kernel_steps = {m: {k: sum(v for n, v in prof[m]["events_by_kernel"].items() if k in n)
                        for k in ("k1_forward", "k2_backward_xstar")} for m in profiled}
    # device us per K1/K2 launch in each mode
    kernel_us = {m: {k: sum(t for n, t in prof[m]["us_by_kernel"].items() if k in n)
                     / max(kernel_steps[m][k], 1) for k in kernel_steps[m]} for m in profiled}

    curves, launched, counts = {}, {}, {}
    runs = [m for m in modes] + (["uncaptured again"] if "uncaptured" in modes else [])
    for label in runs:
        m = label.split(" ")[0]
        fp.reset_launches()
        trainer.reset_graph_counts()
        curves[label] = step(curve_steps, CHUNK_MODES[m][0], 2, CHUNK_MODES[m][1])
        launched[label], counts[label] = dict(fp.launches), dict(trainer.graph_counts)
    for m in ("chunked", "chunk=1"):
        c = counts[m]
        if c["captures"] != 1 or c["replays"] < curve_steps - GRAPH_BASE:
            raise RuntimeError(f"{name}: the {m} curve did not replay one graph: {c}")
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    prel = lambda a, b: max(max_err(a[k], b[k]) / max(float(b[k].abs().max()), 1e-30)
                            for k in b)
    same = lambda a, b: np.array_equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k])
                                                           for k in b[1])
    bitwise = same(curves["chunked"], curves["chunk=1"])
    row = dict(modes=modes, profiled=profiled, host=host,
               capture_s=counts["chunked"]["captures_s"], bitwise_across_chunks=bitwise,
               launches=launched, reads_per_call={k: c["reads"] for k, c in counts.items()},
               wasted={k: c["wasted"] for k, c in counts.items()}, kernel_us=kernel_us,
               k1_per_step=kernel_steps.get("chunked", {}).get("k1_forward"),
               k2_per_step=kernel_steps.get("chunked", {}).get("k2_backward_xstar"),
               profile_faults={m: prof[m]["profile_faults"] for m in profiled},
               **{f"{key}_{m}": prof[m][key] for m in profiled
                  for key in ("busy_ms", "gap_ms", "events", "api_calls", "idle")})
    api = lambda p: ", ".join(f"{k} {v:.0f}" for k, v in list(p["api_by_name"].items())[:3])
    for m in profiled:
        p = prof[m]
        print(f"  graph {name} [{m}]: host ms/step {' / '.join(f'{v:.2f}' for v in host[m])}; "
              f"device busy {p['busy_ms']:.2f} ms/step, idle inside a replay "
              f"{'-' if p['gap_ms'] is None else format(p['gap_ms'], '.2f')} ms "
              f"(least of {p['replays_seen']}); device events per step {p['events']:.1f}; host CUDA "
              f"API calls per step {p['api_calls']:.1f} ({api(p)}); idle share {p['idle']:.3f}; "
              f"K1/K2 per step {kernel_steps[m]['k1_forward']:.1f} / "
              f"{kernel_steps[m]['k2_backward_xstar']:.1f}, device us per launch "
              f"{kernel_us[m]['k1_forward']:.2f} / {kernel_us[m]['k2_backward_xstar']:.2f}; curve "
              f"of {curve_steps} steps: {counts[m]['reads']} host reads, {counts[m]['wasted']} "
              f"iterations after the lanes stopped", flush=True)
    cg = curves["chunked"][0]
    print(f"  graph {name}: capture + instantiate {row['capture_s']:.3f} s; {curve_steps}-step "
          f"curve chunked {' '.join(f'{v:.4f}' for v in np.ravel(cg)[:curve_steps])}; chunked "
          f"against chunk=1 {'bitwise equal' if bitwise else 'NOT bitwise equal'}; launches "
          f"{launched}", flush=True)
    if not bitwise:
        raise RuntimeError(f"{name}: the chunked curve is not bitwise that of chunk=1: "
                           f"{curves['chunked'][0]} against {curves['chunk=1'][0]}")
    if "uncaptured" in modes:
        (cg, pg), (ce, pe), (ce2, pe2) = (curves[k] for k in ("chunked", "uncaptured",
                                                             "uncaptured again"))
        gap, spread_u = (rel(cg, ce), prel(pg, pe)), (rel(ce2, ce), prel(pe2, pe))
        row.update(curve_gap_uncaptured=gap, curve_spread_uncaptured=spread_u)
        print(f"  graph {name}: graphed against uncaptured: costs {gap[0]:.3e}, params "
              f"{gap[1]:.3e} relative (two uncaptured runs: {spread_u[0]:.3e}, "
              f"{spread_u[1]:.3e}); {'bitwise equal' if same(curves['chunked'], curves['uncaptured']) else 'not bitwise'}",
              flush=True)
        if gap[0] > max(spread_u[0], 1e-5) or gap[1] > max(spread_u[1], 1e-5):
            raise RuntimeError(f"{name}: the graphed curve left the uncaptured one: gap {gap}, "
                               f"spread {spread_u}")
    if spread():
        a, b = (max(modes, key=lambda m: prof[m]["events"]),
                min(modes, key=lambda m: prof[m]["events"]))
        ea, eb = prof[a]["events_by_kernel"], prof[b]["events_by_kernel"]
        diff = {k: ea.get(k, 0.0) - eb.get(k, 0.0) for k in ea.keys() | eb.keys()}
        top = sorted(((k, v) for k, v in diff.items() if v), key=lambda kv: -abs(kv[1]))[:6]
        raise RuntimeError(f"{name}: device events per step {events()} ({modes}); {a} - {b} by "
                           f"kernel {top}")
    if any(launched[k] != launched["chunked"] for k in launched):
        raise RuntimeError(f"{name}: K1/K2 counted differently across the modes: {launched}")
    return row


def exit_waste(step, curve_steps=10):
    """The flagship's optimizer made to exit at step 2 (lr0 at lr_min, every
    step a plateau step), chunked and with chunk=1: the iterations run
    after the lane stopped (at most ``POLL_LAG - 1``) and the results
    bitwise equal.  Returns the chunked run's counts."""
    from mcpilco_tpu_torch.control import trainer

    agent = step.agent
    opt = agent.optimizer
    agent.optimizer = dataclasses.replace(opt, min_diff_cost=1e9, num_min_diff_cost=3,
                                          min_step=0.0, lr_min=0.01)
    try:
        out, counts = {}, {}
        for m in ("chunked", "chunk=1"):
            trainer.reset_graph_counts()
            out[m] = step(curve_steps, True, 3, CHUNK_MODES[m][1])
            counts[m] = dict(trainer.graph_counts)
    finally:
        agent.optimizer = opt
    c = counts["chunked"]
    print(f"  graph flagship, made to exit at step 2 of {curve_steps}: chunked {c['reads']} host "
          f"reads, {c['replays'] + c['uncaptured']} iterations, {c['wasted']} after the exit "
          f"(chunk=1: {counts['chunk=1']['reads']} reads, {counts['chunk=1']['wasted']} after)",
          flush=True)
    if len(out["chunked"][0]) != 3 or not np.array_equal(out["chunked"][0], out["chunk=1"][0]):
        raise RuntimeError(f"the forced exit: costs {out}")
    if c["wasted"] > trainer.POLL_LAG - 1 or counts["chunk=1"]["wasted"]:
        raise RuntimeError(f"iterations after the exit: {counts}")
    return c


def graph_phase(fp, dev):
    """Phase 15: every path of ``GRAPH_LABELS`` chunked against chunk=1
    (``graph_ab``; the flagship against uncaptured too; the modes of
    ``GRAPH_PROFILED`` profiled, with ``FULL_PROFILE`` all), the flagship made
    to exit mid-chunk (``exit_waste``), then the flagship's reserved memory
    over three graphed calls (each frees its graph and pool: no growth).
    Prints the rows as one JSON line; returns them."""
    from mcpilco_tpu_torch.utils.profiling import GRAPH_BASE

    rows = {}
    for name in GRAPH_LABELS:
        t0 = time.perf_counter()
        if name not in GRAPH_PATHS:
            GRAPH_PATHS[name] = fit_graph_path(name, fp, dev)
        print(f"  ({GRAPH_LABELS[name]}):", flush=True)
        modes = ["chunked", "chunk=1"] + (["uncaptured"] if name == "flagship" else [])
        profiled = modes if FULL_PROFILE else GRAPH_PROFILED.get(name, [])
        rows[name] = graph_ab(name, GRAPH_PATHS[name], fp, *GRAPH_DEPTH[name], modes, profiled)
        if name == "flagship":
            rows[name]["exit"] = exit_waste(GRAPH_PATHS[name])
        print(f"  ({name}) done in {time.perf_counter() - t0:.1f} s", flush=True)
    reserved = []
    for _ in range(3):
        GRAPH_PATHS["flagship"](GRAPH_BASE + 2, True)
        reserved.append(torch.cuda.memory_reserved(dev))
    print(f"  flagship, three graphed calls: reserved memory after each {reserved} bytes",
          flush=True)
    if reserved[-1] > reserved[0]:
        raise RuntimeError(f"reserved memory grew over graphed calls: {reserved}")
    GRAPH_PATHS.clear()
    print(json.dumps({"graph": rows}), flush=True)
    return rows


# phase 16: the flagship agent of phase 3 (its six trials and fitted GP) and
# phase 7's farm with the replays' clock around it, where those phases ran
MESH_INPUTS = {}
# phase 16's depth: optimizer steps of the particle round and restart lanes,
# the steps of its profiled window, the restart lanes
MESH_STEPS, MESH_WINDOW, MESH_RESTARTS = 5, 1, 4
# the particle axis's tolerances: the JAX package's (tests/test_parallel.py)
# for the costs and final parameters, its end-to-end ones for an executed trial
COST_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
TRIAL_TOL = dict(rtol=1e-3, atol=5e-3)
# a particle-sharded result beyond those tolerances passes only within this
# factor of the largest gap between one-card runs that differ in nothing but
# the order of their float32 sums (the witnesses)
WITNESS_FACTOR = 2.0


def farm_config():
    """Phase 7's farm config (phase 16 holds its farms against phase 7's)."""
    from mcpilco_tpu_torch.scenarios import cartpole

    return cartpole.CartpoleConfig(seed=1, num_trials=1, opt_steps=(10,), gp_epochs=500)


def mesh_ranks() -> int:
    """Phase 16's ranks: the most cards up to 4 whose count tiles the
    farm's 4 seeds (1, 2 or 4)."""
    visible = torch.cuda.device_count()
    return 4 if visible >= 4 else 2 if visible >= 2 else 1


def farm_reference(dev, cfg, size):
    """The farm of ``cfg`` on one card, as ``dryrun.run_farm`` returns it,
    run as one farm per group of ``size`` seeds (a seed group of phase 16's
    mesh) and joined in seed order.  All seeds in one group: phase 7's
    farm, taken from phase 7 where it ran."""
    from mcpilco_tpu_torch.parallel import dryrun

    seeds = list(range(1, FARM_SEEDS + 1))
    if size == FARM_SEEDS and "farm" in MESH_INPUTS:
        res, counts = MESH_INPUTS["farm"]
        per_iter = counts["replays_s"] / counts["replays"]
        return dict(seeds=res.seeds, logs=[log._asdict() for log in res.trial_logs],
                    params={k: v.cpu().numpy() for k, v in res.policy_params.items()},
                    seed_steps_per_s=len(res.seeds) / per_iter)
    return dryrun.join_farms([dryrun.run_farm(dict(cfg=cfg, seeds=seeds[i:i + size],
                                                   device=str(dev)))
                              for i in range(0, FARM_SEEDS, size)])


def mesh_phase(fp, dev):
    """Phase 16: the mesh.  ``dryrun.worker`` on ``mesh_ranks()`` NCCL ranks,
    one card each, at the flagship's full width: (a) the particle round:
    phase 3's six-trial dataset (N=360, M=384), 5 more GP epochs from its
    fitted hyperparameters, then 5 optimizer steps, P=400 over the "p" axis
    (the cost pieces and the gradient all-reduced inside each rank's
    captured graph), profiled per rank; (b) phase 7's farm (seeds 1-4, 1
    trial of 10 steps, 500-epoch fits) over the seed groups; (c) the same
    farm on a 2D ("s", "p") mesh (on 2-4 cards: at world 1 it is (b)'s
    run); (d) 4 restart lanes over ("r", "p").

    Each is held against the same computation on one card in this process,
    and every rank's results against rank 0's, bitwise.  At world 1 every
    result is bitwise the one-card run's.  On 2-4 cards: each seed group's
    farm bitwise the one-card farm of the same seeds (seed sharding adds no
    arithmetic); the particle-sharded results at the JAX package's
    tolerances (COST_TOL, PARAM_TOL, TRIAL_TOL) against one-card runs of the
    same lane batch: the round against the round, the restart lanes against
    lanes run in the ranks' batches, the 2D farm against the one-card farms
    of its seed groups, the steps equal.  A parameter or executed trial
    beyond its tolerance passes only within WITNESS_FACTOR of its witness:
    the largest gap between one-card runs that differ only in the order of
    their sums (the round with its particles reversed and rolled by P/2;
    the farm at the seed-group sizes of the phase).  Every disagreement is
    printed before the phase fails.  Returns the ranks' K1/K2 launches."""
    from mcpilco_tpu_torch.models.gp import tree_map
    from mcpilco_tpu_torch.parallel import dryrun
    from mcpilco_tpu_torch.parallel import mesh as mesh_mod

    n = mesh_ranks()
    visible = torch.cuda.device_count()
    split = n > 1  # a particle axis 2 wide (mesh_shapes)
    if not split:
        print(f"  {visible} card visible: the checks over 2-4 cards did not run; the NCCL path "
              "runs at world 1 (communicator, collectives captured in the graph, results "
              "bitwise the one-card run); (c)'s (1, 1) farm is (b)'s and is not run again",
              flush=True)
    elif n < visible or n < 4:
        print(f"  {visible} cards visible: {n} ranks", flush=True)
    agent = MESH_INPUTS.get("flagship") or fit_graph_path("flagship", fp, dev).agent
    cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)
    inputs = dict(optimizer=agent.optimizer, policy_params=cpu(agent.policy_params),
                  gp_params=cpu(agent.gp_params), data=cpu(agent._padded_data()),
                  key=agent.key, lr0=0.01, p_dropout0=0.25, device=str(dev))
    farm_cfg = farm_config()
    farm = dict(cfg=farm_cfg, seeds=list(range(1, FARM_SEEDS + 1)))
    a, b = dryrun.mesh_shapes(n)
    spec = dict(round=dict(inputs, epochs=5, steps=MESH_STEPS, profile=MESH_WINDOW),
                farm=farm, restart=dict(inputs, restarts=MESH_RESTARTS, steps=MESH_STEPS))
    if split:
        spec["farm2d"] = farm
    t0 = time.perf_counter()
    # the restart lanes in the batches each rank of the (a, b) mesh runs
    ref = dryrun.reference(dict(round=spec["round"],
                                restart=dict(spec["restart"], lane_batch=MESH_RESTARTS // a)))
    farms = {size: farm_reference(dev, farm_cfg, size)
             for size in {FARM_SEEDS, FARM_SEEDS // n, FARM_SEEDS // a}}
    witness = {}
    if split:
        P = agent.optimizer.num_particles
        orders = dict(identity=np.arange(P), reversed=np.arange(P)[::-1].copy(),
                      rolled=np.roll(np.arange(P), P // 2))
        witness = {k: dryrun.run_round(dict(spec["round"], order=o, profile=None))
                   for k, o in orders.items()}
    print(f"  one card: the round, the restart lanes, the farms of {sorted(farms)} seeds and "
          f"{len(witness)} reordered rounds in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    outs = mesh_mod.launch(dryrun.worker, n, "cuda", args=(spec, True), timeout=400)
    print(f"  {n} NCCL ranks: spawned, checked and joined in {time.perf_counter() - t0:.1f} s",
          flush=True)
    faults = []  # every disagreement is printed before the phase fails

    def gap(g, w):
        return float(np.max(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))))

    def rel_gap(g, w):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))

    def agree(got, want, what, tol=None, witness_gaps=None):
        """``tol`` None: bitwise; else np.allclose's keywords, or with
        ``witness_gaps`` ({key: gap}) within WITNESS_FACTOR of the key's."""
        for k, w in want.items():
            if tol is None:
                if not np.array_equal(got[k], w):
                    faults.append(f"{what}: {k} not bitwise (largest gap {gap(got[k], w)})")
                continue
            if np.allclose(got[k], w, **tol):
                continue
            g = gap(got[k], w)
            bound = None if witness_gaps is None else WITNESS_FACTOR * witness_gaps[k]
            if bound is None or not g <= bound:
                faults.append(f"{what}: {k} beyond {tol} (largest gap {g}"
                              f"{'' if bound is None else f', witness bound {bound}'})")

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x
                                                if k != "wall_clock_s")
        if isinstance(x, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        x, y = np.asarray(x), np.asarray(y)
        return x.shape == y.shape and bool(np.all((x == y) | ((x != x) & (y != y))))

    # every rank holds the same bits of every result
    for i, o in enumerate(outs[1:], 1):
        for c in ("round", "restart", "farm", "farm2d"):
            for k in ("cost_history", "params", "logs", "restart_costs", "steps_done"):
                if c in o and k in o[c] and not same(o[c][k], outs[0][c][k]):
                    faults.append(f"rank {i}'s {c} {k} differs from rank 0's")
    bit = None if split else "bitwise"
    r, rr = outs[0]["round"], ref["round"]
    agree(r, dict(steps_done=rr["steps_done"], mll_history=rr["mll_history"]), "round")
    agree(r, dict(cost_history=rr["cost_history"]), "round", COST_TOL if split else None)
    wgap = {}
    if split:
        agree(witness["identity"], dict(cost_history=rr["cost_history"]), "identity witness")
        agree(witness["identity"]["params"], rr["params"], "identity witness params")
        wgap = {k: max(gap(witness[o]["params"][k], v) for o in ("reversed", "rolled"))
                for k, v in rr["params"].items()}
        agree(r["params"], rr["params"], "round params", PARAM_TOL, wgap)
    else:
        agree(r["params"], rr["params"], "round params")
    for o in outs:
        g = o["round"]["graph"]
        if g["captures"] < 1 or g["replays"] < MESH_STEPS - 2:
            faults.append(f"a rank's round did not replay its graph: {g}")
    rs, rsr = outs[0]["restart"], ref["restart"]
    agree(rs, dict(restart_winner=rsr["restart_winner"], steps_done=rsr["steps_done"]),
          "restarts")
    agree(rs, dict(restart_costs=rsr["restart_costs"], cost_history=rsr["cost_history"]),
          "restarts", COST_TOL if split else None)
    if not split:
        agree(rs["params"], rsr["params"], "restart winner params")
    # (b): each seed group bitwise the one-card farm of its seeds
    f1, want1 = outs[0]["farm"], farms[FARM_SEEDS // n]
    for g, w in zip(f1["logs"], want1["logs"]):
        agree(g, {k: w[k] for k in ("steps_done", "cost_history", "control_true")}, "farm")
    agree(f1["params"], want1["params"], "farm params")
    gaps = {}
    for g, w in zip(f1["logs"], farms[FARM_SEEDS]["logs"]):  # phase 7's 4-seed farm
        agree(g, dict(cost_history=w["cost_history"]), "farm against phase 7's farm",
              dict(rtol=1e-3, atol=0.0))

    def farm_gaps(x, y):
        lx, ly = x["logs"][-1], y["logs"][-1]
        return dict(cost_history=gap(lx["cost_history"], ly["cost_history"]),
                    costs_rel=rel_gap(lx["cost_history"], ly["cost_history"]),
                    control_true=gap(lx["control_true"], ly["control_true"]),
                    params=max(gap(x["params"][k], v) for k, v in y["params"].items()),
                    by_leaf={k: gap(x["params"][k], v) for k, v in y["params"].items()})

    gaps["farm"] = farm_gaps(f1, farms[FARM_SEEDS])
    if split:
        # (c): the 2D farm against the one-card farms of its seed groups; its
        # witness: the one-card farms of other seed-group sizes against those
        f2, want2 = outs[0]["farm2d"], farms[FARM_SEEDS // a]
        others = [farm_gaps(farms[sz], want2) for sz in farms if sz != FARM_SEEDS // a]
        fw = {k: max(o[k] for o in others) for k in ("cost_history", "control_true")}
        fw_leaf = {k: max(o["by_leaf"][k] for o in others) for k in want2["params"]}
        for g, w in zip(f2["logs"], want2["logs"]):
            agree(g, dict(steps_done=w["steps_done"]), "farm2d")
            agree(g, dict(cost_history=w["cost_history"]), "farm2d", COST_TOL)
            agree(g, dict(control_true=w["control_true"]), "farm2d", TRIAL_TOL, fw)
        agree(f2["params"], want2["params"], "farm2d params", PARAM_TOL, fw_leaf)
        gaps["farm2d"] = dict(farm_gaps(f2, want2), witness=dict(fw, params=fw_leaf))
    prof, one = [o["round"]["profile"] for o in outs], rr["profile"]
    num = lambda p, k, f="{:.2f}": f.format(p[k]) if k in p else "not measured"

    def step_line(p):
        return (f"{num(p, 'host_ms')} host ms/step, device busy {num(p, 'busy_ms')} ms/step "
                f"({num(p, 'busy_ex_nccl_ms')} without NCCL), "
                f"{num(p, 'events', '{:.0f}')} device events/step, idle "
                f"{num(p, 'idle', '{:.3f}')}, K1/K2 per step {num(p, 'k1_per_step', '{:.0f}')}/"
                f"{num(p, 'k2_per_step', '{:.0f}')}, NCCL kernels per step "
                f"{num(p, 'nccl_calls', '{:.1f}')} taking {num(p, 'nccl_us', '{:.1f}')} device "
                f"us ({p.get('replays_seen')} of {p.get('replays_run')} replays read)")

    costs = " ".join(f"{v:.4f}" for v in r["cost_history"][: r["steps_done"]])
    params_gap = {k: gap(r["params"][k], v) for k, v in rr["params"].items()}
    print(f"  (a) particle round, P={agent.optimizer.num_particles} over {n} ranks: costs "
          f"{costs}, {bit or 'within 2e-4'} against one card; final params' largest gap per "
          f"leaf {({k: f'{v:.3e}' for k, v in params_gap.items()})}"
          + ("" if not split else f"; witness (particles reversed / rolled on one card) "
             f"{({k: f'{v:.3e}' for k, v in wgap.items()})}"), flush=True)
    print(f"      one card: {step_line(one)}", flush=True)
    for i, p in enumerate(prof):
        print(f"      rank {i}: {step_line(p)}", flush=True)
    rates = [o["farm"]["seed_steps_per_s"] for o in outs]
    fg = gaps["farm"]
    print(f"  (b) seed farm, {FARM_SEEDS} seeds over {n} seed group(s): bitwise the one-card "
          f"farms of the same seed groups; against phase 7's 4-seed farm: costs within "
          f"{fg['costs_rel']:.2e} relative, executed trials {fg['control_true']:.3e}, params "
          f"{fg['params']:.3e}; seed-steps/s of the replays {sum(rates):.1f} over {n} card(s) "
          f"({', '.join(f'{v:.1f}' for v in rates)} per rank) against "
          f"{farms[FARM_SEEDS]['seed_steps_per_s']:.1f} on one card; steps "
          f"{f1['logs'][-1]['steps_done'].tolist()}", flush=True)
    if split:
        g2 = gaps["farm2d"]
        print(f"  (c) 2D farm on a ({a}, {b}) seed x particle mesh, against the one-card farms "
              f"of its seed groups: costs within {g2['costs_rel']:.2e} relative, executed "
              f"trials {g2['control_true']:.3e} (witness {g2['witness']['control_true']:.3e}), "
              f"params {g2['params']:.3e} (witness "
              f"{max(g2['witness']['params'].values()):.3e})", flush=True)
    lane_gap = rel_gap(rs["restart_costs"], rsr["restart_costs"])
    winner_gap = max(gap(rs["params"][k], v) for k, v in rsr["params"].items())
    print(f"  (d) {MESH_RESTARTS} restart lanes on a ({a}, {b}) restart x particle mesh: winner "
          f"{rs['restart_winner']} as on one card (lanes in batches of {MESH_RESTARTS // a}), "
          f"lane costs {[round(float(v), 4) for v in rs['restart_costs']]} "
          f"({bit or f'largest relative gap {lane_gap:.2e}'}), winner params' largest gap "
          f"{winner_gap:.3e}", flush=True)
    launches = {k: sum(o[c]["launches"][k] for o in outs for c in o if "launches" in o[c])
                for k in ("fwd", "bwd")}
    if min(launches.values()) == 0:
        faults.append(f"the ranks launched no K1/K2: {launches}")
    print(f"  K1/K2 launches of the {n} ranks: {launches}; per rank "
          f"{[{k: sum(o[c]['launches'][k] for c in o) for k in ('fwd', 'bwd')} for o in outs]}",
          flush=True)
    print(f"  seconds per check in each rank: "
          f"{[{c: round(o[c]['seconds'], 1) for c in o} for o in outs]}", flush=True)
    print(json.dumps({"mesh": dict(
        ranks=n, cards=visible, one_card=one, ranks_profile=prof, farm_seed_steps_per_s=rates,
        farm_one_card_seed_steps_per_s=farms[FARM_SEEDS]["seed_steps_per_s"], farm_gaps=gaps,
        round_params_gap=params_gap, round_params_witness=wgap, restart_lane_gap=lane_gap,
        restart_winner_params_gap=winner_gap)}), flush=True)
    for fault in faults:
        print(f"  phase 16 fault: {fault}", flush=True)
    if faults:
        raise RuntimeError(f"phase 16: {len(faults)} disagreement(s) with the one-card runs")
    return launches


def gpu_clocks():
    """Start ``nvidia-smi``'s reading of the SM clock, its maximum, the power
    draw and the temperature; ``.communicate()[0]`` gives the line.  Started
    before a burst of launches, it reads the card under load."""
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def ab_inputs(shape, dev):
    """K1/K2's inputs and cotangents at one ``AB_SHAPES`` shape (phase 2's
    seeds at L=1; lane l of a lane shape seeded 1000 l further on)."""
    use_poly, g, P, M, d, L = shape
    per = [kernel_inputs(P, M, seed=M + 10 * use_poly + 1000 * l, dev=dev, G=g, D=d)
           for l in range(L)]
    wk, wq = cotangents(P, dev, g)
    if L == 1:
        return per[0], wk, wq
    return ([torch.stack(ts) for ts in zip(*per)],
            *(torch.stack([(l + 1.0) * w for l in range(L)]) for w in (wk, wq)))


def split_us(per):
    """(us of the call's kernels but the partial sums', us of the whole
    call) from ``device_us``'s per-kernel record."""
    return (sum(t for k, t in per.items() if "sum_partials" not in k), sum(per.values()))


def cold_l2_us(fn, flush, iters=20):
    """Mean CUDA-event time of one call of ``fn`` with the L2 flushed before
    it (a 256 MB write, five times the 50 MB L2), beside the same bracket
    without the flush: (cold us, warm us)."""
    out = []
    for cold in (True, False):
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
        for a, b in ev:
            if cold:
                flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        out.append(1e3 * sum(a.elapsed_time(b) for a, b in ev) / iters)
    return tuple(out)


def other_fused_predict(root):
    """``ops/fused_predict.py`` of the checkout at ``root``, imported as a
    module of its own: its wrappers drive its own library, built from its
    own source into its own ``_build/``."""
    import importlib.util
    from pathlib import Path

    path = Path(root).resolve() / "mcpilco_tpu_torch" / "ops" / "fused_predict.py"
    spec = importlib.util.spec_from_file_location("other_fused_predict", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ab(fp, dev, root):
    """K1/K2 of the checkout at ``root`` against this checkout's, built with
    the same flags and timed in turns (root / this / this / root) at
    ``AB_SHAPES``; see the module's docstring."""
    import os

    from mcpilco_tpu_torch.utils.profiling import bound

    mods = {"other": other_fused_predict(root), "this": fp}
    for line in mods["other"].build()[1].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  [other] " + line.strip(), flush=True)
    inputs = {s: ab_inputs(s, dev) for s in AB_SHAPES}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows, outs, plain = [], {}, {}
    for i, turn in enumerate(("other", "this", "this", "other")):
        f = mods[turn]
        for shape in (AB_SHAPES if i % 2 == 0 else AB_SHAPES[::-1]):
            use_poly, g, P, M, d, L = shape
            args, wk, wq = inputs[shape]
            kf = f.fused_gram_contract(*args, use_poly, return_kf=True)[2]
            k1 = lambda: f.fused_gram_contract(*args, use_poly, return_kf=True)
            k2 = lambda: f.fused_gram_contract_bwd_xstar(*args, kf, wk, wq, use_poly)
            if (turn, shape) not in outs:
                out = (*k1(), k2())
                torch.cuda.synchronize()
                outs[turn, shape] = [t.clone() for t in out]
            if turn == "this" and shape not in plain:
                kf_r = fp.reference_gram_contract(*args, use_poly, return_kf=True)[2]
                plain[shape] = [sum(device_us(fn).values()) for fn in (
                    lambda: fp.reference_gram_contract(*args, use_poly),
                    lambda: fp.reference_gram_contract_bwd_xstar(*args, kf_r, wk, wq,
                                                                 use_poly))]
            smi = gpu_clocks()
            events = (cuda_ms(k1, iters=200), cuda_ms(k2, iters=200))
            clocks = smi.communicate()[0].strip()
            row = dict(build=turn, turn=i, use_poly=use_poly, G=g, P=P, M=M, D=d, L=L,
                       k1_events_us=1e3 * events[0], k2_events_us=1e3 * events[1],
                       clocks=clocks, k1_us=[], k1_call_us=[], k2_us=[], k2_call_us=[])
            for _ in range(AB_WINDOWS):
                for key, fn in (("k1", k1), ("k2", k2)):
                    per = device_us(fn)
                    us, call = split_us(per)
                    row[f"{key}_us"].append(us)
                    row[f"{key}_call_us"].append(call)
                    row[f"{key}_kernels"] = {k: round(t, 3) for k, t in per.items()}
            if d > D:
                row["k1_cold_l2_us"], row["k1_warm_bracket_us"] = cold_l2_us(k1, flush)
            rows.append(row)
            print(f"  [{turn}] {'se+p2' if use_poly else 'se'} D={d} G={g} L={L} P={P} M={M}: "
                  f"K1 {' '.join(f'{t:.2f}' for t in row['k1_us'])} us (call "
                  f"{' '.join(f'{t:.2f}' for t in row['k1_call_us'])}), K2 "
                  f"{' '.join(f'{t:.2f}' for t in row['k2_us'])} us (call "
                  f"{' '.join(f'{t:.2f}' for t in row['k2_call_us'])}); events K1 "
                  f"{row['k1_events_us']:.2f} K2 {row['k2_events_us']:.2f} us"
                  + (f"; K1 L2 cold {row['k1_cold_l2_us']:.2f} / warm "
                     f"{row['k1_warm_bracket_us']:.2f} us" if d > D else "")
                  + f"; clocks {clocks}", flush=True)
    # the two builds' outputs on the same inputs: bitwise at the narrow
    # shapes, the largest difference at the wide ones
    summary, narrow_differ = [], []
    for shape in AB_SHAPES:
        use_poly, g, P, M, d, L = shape
        a, b = outs["other", shape], outs["this", shape]
        diff = max(max_err(x, y) for x, y in zip(a, b))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        if d <= 8 and not same:
            narrow_differ.append(shape)
        med = {}
        for build in ("other", "this"):
            rs = [r for r in rows if r["build"] == build and (r["use_poly"], r["G"], r["P"],
                                                                r["M"], r["D"], r["L"]) == shape]
            for key in ("k1_us", "k1_call_us", "k2_us", "k2_call_us"):
                med[f"{build}_{key}"] = float(np.median([t for r in rs for t in r[key]]))
        b1, b2 = (bound(w(L, P, M, use_poly, g, d)) for w in (fp.k1_work, fp.k2_work))
        summary.append(dict(shape=f"{'se+p2' if use_poly else 'se'} D={d} G={g} L={L} P={P} "
                                  f"M={M}", bitwise_equal=same, max_abs_diff=diff,
                            k1_plain_us=plain[shape][0], k2_plain_us=plain[shape][1],
                            k1_bound_us=1e3 * b1[0], k2_bound_us=1e3 * b2[0], **med))
        print(f"  A/B {summary[-1]['shape']}: K1 median other {med['other_k1_us']:.2f} / this "
              f"{med['this_k1_us']:.2f} us (calls {med['other_k1_call_us']:.2f} / "
              f"{med['this_k1_call_us']:.2f}; plain {plain[shape][0]:.2f}, bound "
              f"{1e3 * b1[0]:.2f}), K2 other {med['other_k2_us']:.2f} / this "
              f"{med['this_k2_us']:.2f} us (calls {med['other_k2_call_us']:.2f} / "
              f"{med['this_k2_call_us']:.2f}; plain {plain[shape][1]:.2f}, bound "
              f"{1e3 * b2[0]:.2f}); outputs {'bitwise equal' if same else 'differ'}, max "
              f"|diff| {diff:.3e}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump({"kernel_ab": rows, "summary": summary, "other": str(root)}, f, indent=1)
    print(json.dumps({"kernel_ab": summary, "other": str(root)}), flush=True)
    if narrow_differ:
        raise RuntimeError(f"the two builds' narrow outputs differ at {narrow_differ}")


def farm_sweep(fp, dev, sizes):
    """The farm's optimizer step at the final-trial dataset size for each
    seed count in ``sizes``."""
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.parallel.multiseed import SeedFarm
    from mcpilco_tpu_torch.scenarios import cartpole
    from mcpilco_tpu_torch.utils import prng
    from mcpilco_tpu_torch.utils.profiling import profile_steps

    rows = []
    for S in sizes:
        t0 = time.perf_counter()
        cfg = cartpole.CartpoleConfig(seed=1)
        agent, _ = cartpole.build(cfg, dev)
        farm = SeedFarm(agent, list(range(1, S + 1)),
                        policy_init_fn=lambda k: cartpole.policy_init(cfg, agent.policy, k, dev))
        for i in range(6):
            farm.collect(cfg.T_exploration, trial_index=i, exploration=True)
        t_fit = time.perf_counter()
        farm.fit_model(ModelFitOptions(num_epochs=1501))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        keys = [prng.fold(prng.stream(k, prng.STREAM_ROLLOUT), 0) for k in farm.keys]
        fp.reset_launches()
        p = profile_steps(lane_runner(agent, keys, farm.policy_params, farm.gp_params,
                                      farm.posterior, 0))
        if fp.launched_lanes["fwd"] != S * fp.launches["fwd"] or fp.launches["fwd"] == 0:
            raise RuntimeError(f"S={S}: K1 did not run with {S} lanes")
        row = dict(S=S, N=int(farm.gp_x.shape[1]), M=int(farm.posterior.x_tr.shape[1]),
                   fit_s=fit_s, **p)
        rows.append(row)
        print(f"  farm sweep S={S} N={row['N']} M={row['M']}: {p['host_ms']:.2f} ms/step of all "
              f"seeds ({p['host_ms'] / S:.2f} ms/seed-step), device busy {p['busy_ms']:.2f} "
              f"ms/step, device events per step {p['events']:.0f}, idle share {p['idle']:.3f}; "
              f"fit {fit_s:.1f} s; {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"farm_sweep": rows}))


def step_profile(root):
    """The single-seed flagship step of the package under ``root``, through
    ``cartpole.build``, ``collect``, ``fit_model`` and ``optimizer.optimize``."""
    sys.path.insert(0, root)
    from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
    from mcpilco_tpu_torch.scenarios import cartpole
    from mcpilco_tpu_torch.utils import prng
    from mcpilco_tpu_torch.utils.profiling import profile_steps

    dev = torch.device("cuda", 0)
    agent, _ = cartpole.build(cartpole.CartpoleConfig(seed=1), dev)
    for i in range(6):
        agent.collect(3.0, trial_index=i, exploration=True)
    agent.fit_model(ModelFitOptions(num_epochs=500))

    def run(n):
        agent.optimizer.optimize(prng.root_key(7), agent.policy_params, agent.gp_params,
                                 agent.posterior, n, 0.01, 0.25)
        torch.cuda.synchronize()

    print(json.dumps(dict(root=root, M=int(agent.posterior.x_tr.shape[0]),
                          **profile_steps(run, host_repeats=3))))


def main():
    global FWD_TOL, GRAD_TOL, FULL_PROFILE
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--farm-sweep", default=None,
                        help="comma-separated seed counts: profile the farm's step instead")
    parser.add_argument("--step-profile", default=None, metavar="PATH",
                        help="profile the single-seed step of the checkout at PATH instead")
    parser.add_argument("--kernel-ab", default=None, metavar="PATH",
                        help="time K1/K2 of the checkout at PATH against this one's instead")
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases 2-16 to run after the build (default all)")
    parser.add_argument("--full-profile", action="store_true",
                        help="also profile the steps the default run only times or runs "
                             "(phases 9, 13, 14 (b) and 15; ~+4 min)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check has no CPU path",
              file=sys.stderr)
        return 1
    if args.step_profile:
        card_facts()
        step_profile(args.step_profile)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
        print(json.dumps({"ok": True, "device": device}))
        return 0
    from mcpilco_tpu_torch import disable_tf32
    from mcpilco_tpu_torch.ops import fused_predict as fp
    from mcpilco_tpu_torch.scenarios import cartpole, cartpole_pms, furuta

    FWD_TOL, GRAD_TOL = fp.FWD_TOL, fp.GRAD_TOL
    FULL_PROFILE = args.full_profile
    dev = torch.device("cuda", 0)
    disable_tf32()
    smi = card_facts()

    t0 = time.perf_counter()
    path, log = fp.build()
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling")) or "error" in line.lower():
            print("  " + line.strip(), flush=True)
    phase(f"1 build ({path.name})", t0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}

    if args.farm_sweep:
        t0 = time.perf_counter()
        farm_sweep(fp, dev, [int(v) for v in args.farm_sweep.split(",")])
        phase("farm sweep", t0)
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if args.kernel_ab:
        t0 = time.perf_counter()
        kernel_ab(fp, dev, args.kernel_ab)
        phase("kernel A/B", t0)
        print(json.dumps({"ok": True, "device": device}))
        return 0

    wanted = set(range(2, 17)) if args.phases is None else {int(v) for v in args.phases.split(",")}
    paths, rec = [], None
    if 2 in wanted:
        t0 = time.perf_counter()
        rec = check_kernels(fp, dev)
        time_predicts(dev)
        phase("2 kernels against their plain versions", t0)

    if 3 in wanted:
        t0 = time.perf_counter()
        cfg = cartpole.CartpoleConfig(seed=1)
        GRAPH_PATHS["flagship"] = agent_path(
            policy_step(cartpole.build(cfg, dev)[0], 6, cfg.T_exploration, fp, dev))
        MESH_INPUTS["flagship"] = GRAPH_PATHS["flagship"].agent
        phase("3 flagship policy-optimization step", t0)

    if 4 in wanted:
        # the flagship's own build + reinforce runs in phase 12 (a)
        t0 = time.perf_counter()
        cfg = cartpole.CartpoleConfig(seed=1, num_trials=1, opt_steps=(3,), gp_epochs=500,
                                      multi_init=True)
        paths.append(main_path(cartpole.build(cfg, dev), fp))
        phase("4 multi-init main path: build + reinforce (1 trial)", t0)

    if 5 in wanted:
        t0 = time.perf_counter()
        cfg = cartpole_pms.CartpolePMSConfig(seed=1)
        GRAPH_PATHS["4pms"] = agent_path(
            policy_step(cartpole_pms.build(cfg, dev)[0], 5, cfg.T_exploration, fp, dev,
                        expect_m=M_PMS))
        phase("5 4PMS policy-optimization step", t0)

    if 6 in wanted:
        t0 = time.perf_counter()
        cfg = cartpole_pms.CartpolePMSConfig(seed=1, num_trials=1, opt_steps=(3,), gp_epochs=500)
        paths.append(main_path(cartpole_pms.build(cfg, dev), fp))
        phase("6 4PMS main path: build + reinforce (1 trial)", t0)

    if 7 in wanted:
        t0 = time.perf_counter()
        paths.append(farm_phase(fp, dev))
        phase(f"7 seed farm: {FARM_SEEDS} flagship seeds, 1 trial", t0)

    if 8 in wanted:
        t0 = time.perf_counter()
        paths.append(restart_phase(fp, dev))
        phase("8 restart lanes: 4PMS reinforce with num_restarts=2", t0)

    if 9 in wanted:
        t0 = time.perf_counter()
        cfg = furuta.FurutaConfig(seed=1)
        print("  Furuta, semiparametric Sum(SE, Linear):", flush=True)
        semi = furuta.build(cfg, dev)[0]
        # its K per read against one is phase 15's
        policy_step(semi, 2, cfg.T_exploration, fp, dev, expect_m=320, epochs=500)
        GRAPH_PATHS["furuta"] = agent_path(semi)
        print("  Furuta, SE over 12 dims, on the same two trials:", flush=True)
        # the full fit under the learning curve: a 500-epoch model spread
        # kernel and plain curves 2.4% apart (0.27% at 1501 epochs)
        policy_step(furuta.build(dataclasses.replace(cfg, semiparametric=False), dev)[0], 2,
                    cfg.T_exploration, fp, dev, expect_m=320, profile=FULL_PROFILE,
                    trials=semi.trials)
        phase("9 Furuta policy-optimization step (semiparametric; SE at D=12)", t0)

    if 10 in wanted:
        t0 = time.perf_counter()
        cfg = furuta.FurutaConfig(seed=1, num_trials=1, opt_steps=(3,), gp_epochs=300)
        paths.append(main_path(furuta.build(cfg, dev), fp))
        cfg = dataclasses.replace(cfg, semiparametric=False)
        paths.append(main_path(furuta.build(cfg, dev), fp))
        phase("10 Furuta main path: build + reinforce (1 trial each)", t0)

    if 11 in wanted:
        t0 = time.perf_counter()
        paths.append(sor_phase(fp, dev))
        phase("11 SOR: flagship reinforce, 1 trial", t0)

    if 12 in wanted:
        t0 = time.perf_counter()
        paths.append(entry_points_phase(fp, dev))
        phase("12 entry points: interrupted run, resume, replay, farmed repeat", t0)

    if 13 in wanted:
        t0 = time.perf_counter()
        ur5_launches, ur5_times = ur5_phase(fp, dev)
        paths.append(ur5_launches)
        if rec is not None:
            # the UR5 shape of phase 2's wide cases: its launches on the HIL
            # path and its device time on the fitted posterior
            for key, kernel in (("fwd", "k1"), ("bwd", "k2"), ("gen", "gen")):
                row = next(r for r in rec[key]["by_shape"] if r["shape"].startswith("se+p2 D=24"))
                row.update(launches=ur5_launches[key], real_posterior_ms=1e-3 * ur5_times[kernel])
        phase("13 UR5 from the recorded trials: both models, remat, HIL path", t0)

    if 14 in wanted:
        t0 = time.perf_counter()
        farm_launches, pms = farm_scenarios_phase(fp, dev)
        paths.append(farm_launches)
        if rec is not None:
            # the 4PMS farm's shape of phase 2's lane rows: its launches in
            # (a), over that run's optimizer steps (and their probe rollout)
            for key in ("fwd", "bwd"):
                row = next(r for r in rec[key]["by_shape"] if r["shape"].startswith(
                    f"se D={D} G={G} L={FARM_SEEDS} P=400 M={M_SMALL}"))
                row.update(launches=pms["launches"][key], optimizer_steps=pms["optimizer_steps"])
        phase("14 the farm over 4PMS, Furuta, a host plant; repeat --farm; legacy variance", t0)

    if 12 in wanted:
        t0 = time.perf_counter()
        summarize_phase()
        phase("12 (f) summarize_results over the sweeps of phases 12 and 14", t0)

    if 15 in wanted:
        t0 = time.perf_counter()
        graph_phase(fp, dev)
        phase("15 loop: K iterations per host read against one, on five paths", t0)

    if 16 in wanted:
        t0 = time.perf_counter()
        paths.append(mesh_phase(fp, dev))
        phase(f"16 the mesh: {mesh_ranks()} NCCL rank(s) at full flagship width", t0)

    print(smi, flush=True)  # again beside the results, for logs that keep only the end
    if rec is None or wanted != set(range(2, 17)):
        print(json.dumps({"ok": True, "device": device}))
        return 0
    src = "mcpilco_tpu_torch/csrc/fused_predict.cu"
    kernels = [
        dict(name="fused_gram_contract (K1)", route="cuda", source=src,
             replaces="mcpilco_tpu/ops/fused_predict.py:225",
             launches=sum(p["fwd"] for p in paths), **rec["fwd"]),
        dict(name="fused_gram_contract_bwd_xstar (K2)", route="cuda", source=src,
             replaces="mcpilco_tpu/ops/fused_predict.py:271",
             launches=sum(p["bwd"] for p in paths), **rec["bwd"]),
        # K1's generation pass above 8 input dims: the k* generation of the
        # TPU kernel's body (distance, exp, polynomial terms, mask, kalpha)
        dict(name="k1_gen (K1's generation pass, D > 8)", route="cuda", source=src,
             replaces="mcpilco_tpu/ops/fused_predict.py:87",
             launches=sum(p.get("gen", 0) for p in paths), **rec["gen"]),
    ]
    if not all(math.isfinite(k["ms"]) and math.isfinite(k["bound_ms"]) for k in kernels):
        raise RuntimeError("kernel timing missing")
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError(f"a kernel of the main paths was never launched: "
                           f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
