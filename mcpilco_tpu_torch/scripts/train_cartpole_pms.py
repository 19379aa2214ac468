"""Train MC-PILCO-4PMS on the cart-pole with a modeled measurement system.

    python -m mcpilco_tpu_torch.scripts.train_cartpole_pms --seed 1
    python -m mcpilco_tpu_torch.scripts.train_cartpole_pms --num-restarts 4
    python -m mcpilco_tpu_torch.scripts.train_cartpole_pms --smoke --device cpu

Checkpoints go to ``--log-dir`` (default ``results_tmp/torch/pms_<seed>``);
``--auto-resume`` continues from the newest completed trial there.
"""

from ..scenarios import cartpole_pms as scen
from . import _train


def run(cfg: scen.CartpolePMSConfig, device="cuda", auto_resume: bool = False):
    """Train ``cfg`` on ``device``; returns (agent, number of trials resumed)."""
    return _train.train(scen, cfg, device, auto_resume, "train_cartpole_pms", angle_index=2)


def parse(argv=None):
    """The config and the flags that ``argv`` gives."""
    p = _train.parser("train cartpole 4pms")
    p.add_argument("--vel-est", type=str, default="butter_cd", choices=("butter_cd", "savgol"),
                   help="offline velocity estimator of the GP targets: Butterworth + central "
                        "differences, or Savitzky-Golay")
    p.add_argument("--num-restarts", type=int, default=1,
                   help="policy-init restarts per trial; winner by in-model cost")
    p.add_argument("--sequential-restarts", action="store_true",
                   help="run the restart lanes one after another instead of lane-batched")
    args = p.parse_args(argv)
    cfg = _train.config(scen.CartpolePMSConfig(
        seed=args.seed, vel_est=args.vel_est, num_restarts=args.num_restarts,
        restart_vmap=not args.sequential_restarts,
        log_dir=args.log_dir or f"results_tmp/torch/pms_{args.seed}",
    ), args)
    return cfg, args


def main(argv=None) -> int:
    cfg, args = parse(argv)
    agent, _ = run(cfg, args.device, args.auto_resume)
    return _train.exit_code(scen, agent, args)


if __name__ == "__main__":
    raise SystemExit(main())
