"""Train MC-PILCO on the simulated cart-pole swing-up (the flagship).

    python -m mcpilco_tpu_torch.scripts.train_cartpole --seed 1               # SE+P(2) + SOD
    python -m mcpilco_tpu_torch.scripts.train_cartpole --kernel se --no-sod
    python -m mcpilco_tpu_torch.scripts.train_cartpole --multi-init           # bimodal x0
    python -m mcpilco_tpu_torch.scripts.train_cartpole --smoke --device cpu   # tiny config

Checkpoints go to ``--log-dir`` (default ``results_tmp/torch/<seed>``);
``--auto-resume`` continues from the newest completed trial there.
"""

from ..scenarios import cartpole as scen
from . import _train


def run(cfg: scen.CartpoleConfig, device="cuda", auto_resume: bool = False):
    """Train ``cfg`` on ``device``; returns (agent, number of trials resumed)."""
    return _train.train(scen, cfg, device, auto_resume, "train_cartpole", angle_index=2)


def parse(argv=None):
    """The config and the flags that ``argv`` gives."""
    p = _train.parser("train cartpole")
    p.add_argument("--kernel", choices=["se+p2", "se"], default="se+p2")
    p.add_argument("--no-sod", action="store_true")
    p.add_argument("--multi-init", action="store_true")
    args = p.parse_args(argv)
    cfg = _train.config(scen.CartpoleConfig(
        seed=args.seed, kernel=args.kernel, use_sod=not args.no_sod,
        multi_init=args.multi_init, log_dir=args.log_dir or f"results_tmp/torch/{args.seed}",
    ), args)
    return cfg, args


def main(argv=None) -> int:
    cfg, args = parse(argv)
    agent, _ = run(cfg, args.device, args.auto_resume)
    return _train.exit_code(scen, agent, args)


if __name__ == "__main__":
    raise SystemExit(main())
