"""Sort each seed of a sweep into its failure mode (the JAX package's
``scripts/analyze_mujoco_failures.py``).

For every seed's newest ``complete_trial*`` checkpoint it separates the two
ways a seed fails:

- OPTIMIZATION failure: the optimizer never found a swing-up even in its own
  model (the in-model particles' upright fraction is low).  Levers: restarts
  (``PolicyOptimizer.num_restarts``), exploration, the optimizer's budget.
- MODEL-OPTIMISM failure: the policy swings up the learned model but not the
  plant (in-model upright fraction high, the executed trial fails).  Levers:
  model capacity, data coverage, rollout stabilizers.

It also reports the final model's one-step prediction RMSE along the
executed final trial (``analyze_pms_bias``'s method), so that the model's
quality is measured, not guessed, and for a rollout engine with a
``delta_cap`` (Furuta) the share of in-model particle-steps at which the cap
binds (``delta_cap_share``, read by ``utils/cap_probe`` on the in-model
rollout that :func:`in_model_states` runs; None without a cap).

    python -m mcpilco_tpu_torch.scripts.analyze_mujoco_failures --scenario pms
    python -m mcpilco_tpu_torch.scripts.analyze_mujoco_failures --scenario furuta \\
        --root results_tmp/torch --seeds 4,5 --device cpu --json rows.json

Run dirs are ``<root>/<prefix>[_<tag>]_<seed>`` (``repeat``'s log dirs;
``--root`` defaults to ``results_tmp/torch``, where the port's ``repeat``
writes).  The rows have the JAX script's keys and the same mode
thresholds; their numbers are not rounded (the printed lines are), so a
caller can hold ``executed_cost`` against the run's own cost.  ``main(argv)``
returns the rows.  Runs on the card unless ``--device cpu``.
"""

import argparse
import glob
import json
import os
import re

import numpy as np
import torch

from ..control.rollout import RolloutNoise
from ..utils.cap_probe import CapShares, delta_cap_binding


def mujoco_upright_fraction(states):
    """The MuJoCo cart-pole's oracle per particle: the angle (index 1)
    wrapped to 0 upright within 0.25 and |x| < 0.5, over the final quarter.
    ``states`` [H, P, D]."""
    tail = states[-(states.shape[0] // 4):]
    wrapped = np.abs((tail[:, :, 1] + np.pi) % (2 * np.pi) - np.pi)
    ok = np.all(wrapped < 0.25, axis=0) & np.all(np.abs(tail[:, :, 0]) < 0.5, axis=0)
    return float(ok.mean())


def furuta_upright_fraction(states):
    """The Furuta oracle per particle: |theta_v| (index 1) within 0.3 of pi
    over the final quarter."""
    tail = states[-(states.shape[0] // 4):]
    ok = np.all(np.abs(np.abs(tail[:, :, 1]) - np.pi) < 0.3, axis=0)
    return float(ok.mean())


def cartpole_upright_fraction(states):
    """The ODE cart-pole's oracle per particle (4PMS too): |theta| (index 2)
    within 0.25 of pi and |x| (index 0) < 0.5 over the final quarter."""
    tail = states[-(states.shape[0] // 4):]
    ok = np.all(np.abs(np.abs(tail[:, :, 2]) - np.pi) < 0.25, axis=0) & np.all(
        np.abs(tail[:, :, 0]) < 0.5, axis=0
    )
    return float(ok.mean())


def _scenarios():
    # imported here: the MuJoCo scenario's module is needed only for its rows
    from ..scenarios import cartpole_mujoco, cartpole_pms, furuta

    return {
        "mujoco": dict(mod=cartpole_mujoco, cfg=cartpole_mujoco.CartpoleMujocoConfig,
                       prefix="cartpole_mujoco", upright=mujoco_upright_fraction,
                       heads=("xd", "thd")),
        "furuta": dict(mod=furuta, cfg=furuta.FurutaConfig, prefix="furuta",
                       upright=furuta_upright_fraction, heads=("dth_h", "dth_v")),
        "pms": dict(mod=cartpole_pms, cfg=cartpole_pms.CartpolePMSConfig,
                    prefix="cartpole_pms", upright=cartpole_upright_fraction,
                    heads=("xd", "thd")),
    }


@torch.no_grad()
def in_model_states(agent) -> np.ndarray:
    """The final policy's in-model rollout [H, P, ds] for a checkpoint
    without particle snapshots: the optimizer's engine on the restored
    posterior, with fresh noise from a ``torch.Generator`` seeded 0 (the JAX
    script takes ``PRNGKey(0)``), no dropout."""
    opt, dev = agent.optimizer, agent.device
    gen = torch.Generator(device=dev).manual_seed(0)
    P, H, dist = opt.num_particles, opt.horizon, opt.init_dist
    idx = None
    if dist.kind == "multi_gauss":
        idx = torch.randint(0, len(dist.mean), (P,), generator=gen, device=dev)
    draw = torch.rand if dist.kind == "uniform" else torch.randn
    width = len(dist.low) if dist.kind == "uniform" else np.shape(dist.mean)[-1]
    s0 = dist.sample(None, P, dev, eps=draw((P, width), generator=gen, device=dev), idx=idx)
    engine = opt.engine
    meas = None
    if engine.sensors is not None:
        meas = torch.randn((H - 1, P, len(engine.sensors.pos_indices)), generator=gen, device=dev)
    noise = RolloutNoise(state=torch.randn((H - 1, P, agent.gp.num_heads), generator=gen,
                                           device=dev), meas=meas)
    sim = engine.simulate(None, agent.policy_params, agent.gp_params, agent.posterior, s0, H,
                          p_dropout=0.0, noise=noise)
    return sim.states.cpu().numpy()


def mode_of(executed_ok, in_model_frac) -> str:
    """The JAX script's thresholds: a success; model optimism at an in-model
    upright fraction of at least 0.5; optimization below 0.1; else mixed."""
    if executed_ok:
        return "success"
    if not np.isnan(in_model_frac) and in_model_frac >= 0.5:
        return "model-optimism"
    if not np.isnan(in_model_frac) and in_model_frac < 0.1:
        return "optimization"
    return "mixed"


@torch.no_grad()
def analyze_seed(scenario: str, seed: int, ckpt: str, device) -> dict:
    """One row: the checkpoint ``ckpt`` restored into the scenario's default
    config built on ``device``."""
    spec = _scenarios()[scenario]
    scen = spec["mod"]
    agent, _ = scen.build(spec["cfg"](seed=seed), device)
    agent.load_checkpoint(ckpt)

    final = agent.trials[-1]
    executed_cost = agent.trial_cumulative_cost(-1)
    executed_ok = bool(scen.swingup_success(final.true))

    log = agent.trial_logs[-1]
    cost_hist = log.cost_history[: log.steps_done]
    in_model_cost = float(np.mean(cost_hist[-20:])) if len(cost_hist) else float("nan")
    p_states = np.asarray(log.particles_states)
    cap_share = None
    if p_states.ndim != 3 or agent.optimizer.engine.delta_cap is not None:
        # the final policy's in-model rollout, rebuilt with fresh noise: the
        # states of a checkpoint without particle snapshots, and the cap's
        # binding share
        shares = CapShares()
        with delta_cap_binding(shares):
            states = in_model_states(agent)
        if p_states.ndim != 3:
            p_states = states
        if agent.optimizer.engine.delta_cap is not None:
            cap_share = shares.share()
    in_model_frac = spec["upright"](p_states) if p_states.ndim == 3 else float("nan")

    # the one-step model error along the executed trial (true plant states)
    n = final.inputs.shape[0]
    x_true, y_true = agent.model.training_pairs(
        torch.as_tensor(final.true[:n], dtype=torch.float32, device=agent.device),
        torch.as_tensor(final.inputs, dtype=torch.float32, device=agent.device))
    mean_true, _ = agent.gp.predict(agent.gp_params, agent.posterior, x_true)
    res = (mean_true - y_true).cpu().numpy()
    y = y_true.cpu().numpy()
    rmse = [float(np.sqrt((res[g] ** 2).mean())) for g in range(res.shape[0])]
    scale = [float(np.abs(y[g]).mean()) for g in range(res.shape[0])]
    return dict(scenario=scenario, seed=seed, executed_cost=executed_cost,
                executed_success=executed_ok, in_model_cost=in_model_cost,
                in_model_upright_frac=in_model_frac, onestep_rmse=rmse, mean_abs_delta=scale,
                delta_cap_share=cap_share, mode=mode_of(executed_ok, in_model_frac))


def run_dirs(root: str, prefix: str, seeds=None):
    """(seed, run dir) of ``<root>/<prefix>_<seed>``: the ``seeds`` given,
    else every such dir."""
    if seeds is None:
        seeds = sorted(int(m.group(1)) for d in glob.glob(os.path.join(root, f"{prefix}_*"))
                       if (m := re.fullmatch(rf".*{prefix}_(\d+)", d)))
    return [(s, os.path.join(root, f"{prefix}_{s}")) for s in seeds]


def main(argv=None) -> list:
    p = argparse.ArgumentParser("analyze_mujoco_failures")
    p.add_argument("--scenario", default="mujoco", choices=("mujoco", "furuta", "pms"))
    p.add_argument("--root", default=os.path.join("results_tmp", "torch"))
    p.add_argument("--seeds", default=None, help="comma list; default: all run dirs")
    p.add_argument("--tag", default=None,
                   help="the sweep's out-tag (repeat --out-tag): run dirs are "
                        "<prefix>_<tag>_<seed> instead of <prefix>_<seed>")
    p.add_argument("--device", default="cuda", help="cpu to run on the CPU")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    spec = _scenarios()[args.scenario]
    prefix = spec["prefix"] + (f"_{args.tag}" if args.tag else "")
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else None
    h = spec["heads"]
    rows = []
    for seed, run_dir in run_dirs(args.root, prefix, seeds):
        ckpts = sorted(glob.glob(os.path.join(run_dir, "complete_trial*")))
        if not ckpts:
            print(f"seed {seed}: no checkpoints under {run_dir}, skipping")
            continue
        r = analyze_seed(args.scenario, seed, ckpts[-1], args.device)
        rows.append(r)
        rmse, scale = r["onestep_rmse"], r["mean_abs_delta"]
        print(
            f"seed {seed}: executed cost {r['executed_cost']:7.2f} "
            f"success={r['executed_success']} | in-model cost {r['in_model_cost']:6.2f} "
            f"upright-frac {r['in_model_upright_frac']:.2f} | 1-step rmse ({h[0]}, {h[1]}) "
            f"{rmse[0]:.3f}/{rmse[1]:.3f} (|delta| scale {scale[0]:.2f}/{scale[1]:.2f}) "
            + ("" if r["delta_cap_share"] is None
               else f"cap binds {r['delta_cap_share']:.4f} ")
            + f"-> {r['mode']}", flush=True)

    n_fail = sum(1 for r in rows if not r["executed_success"])
    n_opt = sum(1 for r in rows if r["mode"] == "optimization")
    n_bias = sum(1 for r in rows if r["mode"] == "model-optimism")
    print(f"\n{len(rows)} seeds, {n_fail} failures: {n_opt} optimization-mode, "
          f"{n_bias} model-optimism, {n_fail - n_opt - n_bias} mixed")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
