"""Train MC-PILCO on the MuJoCo cart-pole swing-up.

    python -m mcpilco_tpu_torch.scripts.train_cartpole_mujoco --seed 1
    python -m mcpilco_tpu_torch.scripts.train_cartpole_mujoco --smoke --device cpu

The plant needs the ``mujoco`` package.  Checkpoints go to ``--log-dir``
(default ``results_tmp/torch/mj_<seed>``); ``--auto-resume`` continues from
the newest completed trial there.
"""

import numpy as np

from ..scenarios import cartpole_mujoco as scen
from . import _train


def run(cfg: scen.CartpoleMujocoConfig, device="cuda", auto_resume: bool = False):
    """Train ``cfg`` on ``device`` and print the final trial's swing-up
    success, cumulative cost and tail of theta and x (upright is theta = 0
    in the MuJoCo layout); returns (agent, number of trials resumed)."""
    tag = "train_cartpole_mujoco"
    agent, done = _train.build_and_train(scen, cfg, device, auto_resume, tag)
    final = agent.trials[-1]
    print(f"[{tag}] final-trial swing-up success: {scen.swingup_success(final.true)}")
    print(f"[{tag}] final-trial cumulative cost: {agent.trial_cumulative_cost():.4f}")
    print(f"[{tag}] tail theta:", np.round(final.true[-5:, 1], 3),
          " x:", np.round(final.true[-5:, 0], 3))
    return agent, done


def parse(argv=None):
    """The config and the flags that ``argv`` gives."""
    p = _train.parser("train cartpole mujoco")
    p.add_argument("--delta-cap", type=float, default=None,
                   help="cap per-step rollout deltas at this multiple of the largest training "
                        "delta (default off)")
    p.add_argument("--num-restarts", type=int, default=1,
                   help="policy-init restarts per trial; winner by in-model cost")
    p.add_argument("--sequential-restarts", action="store_true",
                   help="run the restart lanes one after another instead of lane-batched")
    p.add_argument("--cost-lengthscales", choices=["fixed", "curriculum"], default="fixed",
                   help="'curriculum': wide trial-0 cost lengthscales (6.0, 2.0), then (3.0, 1.0)")
    args = p.parse_args(argv)
    cfg = _train.config(scen.CartpoleMujocoConfig(
        seed=args.seed, log_dir=args.log_dir or f"results_tmp/torch/mj_{args.seed}",
        delta_cap=args.delta_cap, num_restarts=args.num_restarts,
        restart_vmap=not args.sequential_restarts, cost_lengthscales=args.cost_lengthscales,
    ), args)
    return cfg, args


def main(argv=None) -> int:
    cfg, args = parse(argv)
    agent, _ = run(cfg, args.device, args.auto_resume)
    return _train.exit_code(scen, agent, args)


if __name__ == "__main__":
    raise SystemExit(main())
