"""Train MC-PILCO on UR5 joint-space trajectory tracking (MuJoCo arm).

    python -m mcpilco_tpu_torch.scripts.train_ur5 --seed 1
    python -m mcpilco_tpu_torch.scripts.train_ur5 --poly-degree 2   # K1/K2 on the card
    python -m mcpilco_tpu_torch.scripts.train_ur5 --smoke --device cpu

The plant needs the ``mujoco`` package.  Checkpoints go to ``--log-dir``
(default ``results_tmp/torch/ur5_<seed>``); ``--auto-resume`` continues from
the newest completed trial there.  The plateau rescue: when trial 0 ends
with its cost above ``--plateau-rescue-frac`` x horizon (the saturated
tracking cost's flat region, where the gradient vanishes), the run restarts
once from scratch with the per-trial cost-lengthscale curriculum, logging
to ``<log dir>_rescue``.
"""

import argparse
import dataclasses

import numpy as np

from ..scenarios import ur5 as scen
from . import _train


class _Plateau(Exception):
    """Trial 0 ended on the saturated cost's flat region; carries its last cost."""


def _is_plateau(cfg: scen.UR5Config, cost_history) -> bool:
    horizon = int(cfg.T_control / cfg.dt)
    return bool(cfg.plateau_rescue and cfg.cost_lengthscales == "fixed" and len(cost_history)
                and float(cost_history[-1]) > cfg.plateau_rescue_frac * horizon)


def _train_once(cfg: scen.UR5Config, device, auto_resume: bool):
    def check(agent, trial=0):
        # right after trial 0 (or on resuming a run past it): the rescue
        # costs one trial 0, not a failed run
        if trial == 0 and agent.trial_logs and _is_plateau(cfg, agent.trial_logs[0].cost_history):
            raise _Plateau(float(agent.trial_logs[0].cost_history[-1]))

    return _train.build_and_train(scen, cfg, device, auto_resume, "train_ur5",
                                  on_resumed=check, on_trial_end=check)


def run(cfg: scen.UR5Config, device="cuda", auto_resume: bool = False):
    """Train ``cfg`` on ``device``, with the plateau rescue; prints the
    tracking result lines.  Returns (agent, number of trials resumed)."""
    try:
        agent, done = _train_once(cfg, device, auto_resume)
        rescue_fired = False
    except _Plateau as e:
        print(f"\n[train_ur5] PLATEAU: trial-0 policy opt ended saturated (cost {e.args[0]:.1f}); "
              "restarting with the cost-lengthscale curriculum")
        rescue = dataclasses.replace(cfg, cost_lengthscales="curriculum",
                                     log_dir=cfg.log_dir + "_rescue" if cfg.log_dir else None)
        agent, done = _train_once(rescue, device, False)
        rescue_fired = True
    err = scen.tracking_error_deg(agent)
    print(f"[train_ur5] rescue_fired: {rescue_fired}")
    print(f"[train_ur5] final-trial per-joint RMS tracking error (deg): {np.round(err, 2)}")
    print(f"[train_ur5] final-trial cumulative cost: {agent.trial_cumulative_cost():.4f}")
    print(f"[train_ur5] tracking success: {scen.tracking_success(agent)}  "
          "(threshold: <10 deg RMS on all joints)")
    return agent, done


def parse(argv=None):
    """The config and the flags that ``argv`` gives."""
    p = _train.parser("train ur5 tracking")
    p.add_argument("--trajectory", choices=["generated", "reference"], default="generated",
                   help="'reference' reads the original task's recorded CSV from "
                        "$MCPILCO_REFERENCE")
    p.add_argument("--plant", choices=["approx", "reference"], default="approx",
                   help="'reference' runs the original task's arm from $MCPILCO_REFERENCE")
    p.add_argument("--poly-degree", type=int, default=1,
                   help="degree of the kernel's polynomial part (2: the fused kernels' structure)")
    p.add_argument("--cost-lengthscales", choices=["curriculum", "fixed"], default="fixed")
    p.add_argument("--weight-init-scale", type=float, default=0.02,
                   help="policy weights uniform in +-this")
    p.add_argument("--delta-cap", type=float, default=3.0,
                   help="rollout delta clamp in units of the max-abs training delta; <=0 disables")
    p.add_argument("--plateau-rescue", action=argparse.BooleanOptionalAction, default=True,
                   help="restart once with the cost curriculum when trial 0 ends saturated")
    p.add_argument("--plateau-rescue-frac", type=float, default=0.9,
                   help="plateau threshold as a fraction of the horizon")
    args = p.parse_args(argv)
    cfg = _train.config(scen.UR5Config(
        seed=args.seed, log_dir=args.log_dir or f"results_tmp/torch/ur5_{args.seed}",
        trajectory=args.trajectory, plant=args.plant, poly_degree=args.poly_degree,
        cost_lengthscales=args.cost_lengthscales, weight_init_scale=args.weight_init_scale,
        delta_cap=args.delta_cap if args.delta_cap > 0 else None,
        plateau_rescue=args.plateau_rescue, plateau_rescue_frac=args.plateau_rescue_frac,
    ), args)
    return cfg, args


def main(argv=None) -> int:
    cfg, args = parse(argv)
    agent, _ = run(cfg, args.device, args.auto_resume)
    return 0 if (scen.tracking_success(agent) or args.smoke) else 1


if __name__ == "__main__":
    raise SystemExit(main())
