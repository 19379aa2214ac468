"""Replay a trained policy on the true system or on the learned model.

    python -m mcpilco_tpu_torch.scripts.apply_policy results_tmp/torch/1/complete_trial4
    python -m mcpilco_tpu_torch.scripts.apply_policy CKPT --target model --repeats 400

Reloads a checkpoint written by either package, rebuilds its scenario from
the config stored in it (without a log dir: a replay never writes into the
training run's directory), then runs the policy ``--repeats`` times on the
plant (``--target system``: cost mean and std over the runs) or rolls
``--repeats`` particles through the learned GP model (``--target model``).
"""

import argparse
import os

import numpy as np
import torch

from ..scenarios import cartpole, cartpole_mujoco, cartpole_pms, furuta, ur5
from ..utils import checkpoint as ckpt
from ..utils import prng

SCENARIOS = {
    "cartpole": (cartpole, cartpole.CartpoleConfig),
    "cartpole_pms": (cartpole_pms, cartpole_pms.CartpolePMSConfig),
    "furuta": (furuta, furuta.FurutaConfig),
    "cartpole_mujoco": (cartpole_mujoco, cartpole_mujoco.CartpoleMujocoConfig),
    "ur5": (ur5, ur5.UR5Config),
}


def _tuplify(v):
    return tuple(_tuplify(x) for x in v) if isinstance(v, list) else v


def load_agent(checkpoint: str, device="cuda", scenario: str = "cartpole", seed: int = 1):
    """The agent of ``checkpoint``, built from its stored scenario config (or
    ``scenario``'s defaults at ``seed`` when it stores none) and restored."""
    stored = ckpt.peek_meta(checkpoint).get("scenario")
    if stored and stored.get("name"):
        scenario = stored["name"]
    if scenario not in SCENARIOS:
        raise SystemExit(f"the port has no scenario {scenario!r} (it has {sorted(SCENARIOS)})")
    scen, cfg_cls = SCENARIOS[scenario]
    if stored:
        cfg = cfg_cls(**{**{k: _tuplify(v) for k, v in stored["config"].items()},
                         "log_dir": None})
        print(f"[apply_policy] rebuilt '{scenario}' from checkpoint config")
    else:
        cfg = cfg_cls(seed=seed)
    agent, _ = scen.build(cfg, device)
    agent.load_checkpoint(checkpoint)
    print(f"loaded {checkpoint}: {agent.num_collections} collections")
    return agent


@torch.no_grad()
def replay_system(agent, repeats: int, T: float) -> np.ndarray:
    """The policy on the plant ``repeats`` times; returns each run's
    cumulative cost [repeats]."""
    costs = []
    for r in range(repeats):
        k = prng.fold(prng.stream(agent.key, prng.STREAM_SYSTEM), 0xEE, r)
        trial = agent.plant.rollout(k, agent._sample_x0(1000 + r), agent.policy,
                                    agent.policy_params, T, agent.dt, device=agent.device)
        c = agent.cost.stage_costs(torch.as_tensor(trial.true)[:, None, :],
                                   torch.as_tensor(trial.inputs)[:, None, :])
        costs.append(float(torch.sum(c)))
    return np.asarray(costs)


@torch.no_grad()
def replay_model(agent, particles: int, T: float):
    """``particles`` particles through the learned model for T seconds;
    returns (expected cost, particle std of the cost, states [T, P, ds])."""
    s0 = agent.init_dist.sample(prng.root_key(0), particles, agent.device)
    res = agent.optimizer.engine.simulate(
        prng.root_key(1), agent.policy_params, agent.gp_params, agent.posterior, s0,
        int(T / agent.dt), p_dropout=0.0,
    )
    total, spread = agent.cost(res.states, res.inputs)
    return float(total), float(spread), res.states.cpu().numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("apply trained policy")
    p.add_argument("checkpoint", help="checkpoint dir (e.g. results_tmp/torch/1/policy_trial4)")
    p.add_argument("--scenario", default="cartpole", choices=sorted(SCENARIOS),
                   help="used when the checkpoint stores no scenario")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--target", choices=["system", "model"], default="system")
    p.add_argument("--repeats", type=int, default=50)
    p.add_argument("--T", type=float, default=3.0)
    p.add_argument("--device", type=str, default="cuda", help="cpu to run on the CPU")
    args = p.parse_args(argv)
    if not os.path.isdir(args.checkpoint):
        raise SystemExit(f"no checkpoint directory {args.checkpoint}")

    agent = load_agent(args.checkpoint, args.device, args.scenario, args.seed)
    if args.target == "system":
        costs = replay_system(agent, args.repeats, args.T)
        for r in sorted({*range(min(5, len(costs))), len(costs) - 1}):
            print(f"  run {r}: cumulative cost {costs[r]:.2f}")
        print(f"[apply_policy] system: cost over {args.repeats} runs: mean {np.mean(costs):.2f} "
              f"+- {np.std(costs):.2f} (min {np.min(costs):.2f})")
    else:
        total, spread, states = replay_model(agent, args.repeats, args.T)
        print(f"[apply_policy] model: {args.repeats} particles x {states.shape[0]} steps: "
              f"cost {total:.2f} (particle std {spread:.2f})")
        print(f"  final-state mean: {np.round(states[-1].mean(axis=0), 3)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
