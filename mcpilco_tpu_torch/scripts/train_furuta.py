"""Train MC-PILCO on the Furuta-pendulum swing-up with the semiparametric model.

    python -m mcpilco_tpu_torch.scripts.train_furuta --seed 1
    python -m mcpilco_tpu_torch.scripts.train_furuta --no-semiparametric   # SE over 12 dims
    python -m mcpilco_tpu_torch.scripts.train_furuta --smoke --device cpu

Checkpoints go to ``--log-dir`` (default ``results_tmp/torch/furuta_<seed>``);
``--auto-resume`` continues from the newest completed trial there.
"""

from ..scenarios import furuta as scen
from . import _train


def run(cfg: scen.FurutaConfig, device="cuda", auto_resume: bool = False):
    """Train ``cfg`` on ``device``; returns (agent, number of trials resumed)."""
    return _train.train(scen, cfg, device, auto_resume, "train_furuta", angle_index=1)


def parse(argv=None):
    """The config and the flags that ``argv`` gives."""
    p = _train.parser("train furuta")
    p.add_argument("--no-semiparametric", action="store_true")
    p.add_argument("--num-restarts", type=int, default=1,
                   help="policy-init restarts per trial; winner by in-model cost")
    p.add_argument("--sequential-restarts", action="store_true",
                   help="run the restart lanes one after another instead of lane-batched")
    args = p.parse_args(argv)
    cfg = _train.config(scen.FurutaConfig(
        seed=args.seed, semiparametric=not args.no_semiparametric,
        num_restarts=args.num_restarts, restart_vmap=not args.sequential_restarts,
        log_dir=args.log_dir or f"results_tmp/torch/furuta_{args.seed}",
    ), args)
    return cfg, args


def main(argv=None) -> int:
    cfg, args = parse(argv)
    agent, _ = run(cfg, args.device, args.auto_resume)
    return _train.exit_code(scen, agent, args)


if __name__ == "__main__":
    raise SystemExit(main())
