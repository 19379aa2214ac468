"""What the train scripts share: their common flags, and the run
itself (build, optional auto-resume, ``reinforce``, the result lines)."""

import argparse
import dataclasses
import time

import numpy as np


def parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--trials", type=int, default=None)
    p.add_argument("--opt-steps", type=int, default=None,
                   help="optimizer steps of every trial (a depth cut for a quick run)")
    p.add_argument("--gp-epochs", type=int, default=None,
                   help="epochs of every model fit (a depth cut for a quick run)")
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cpu to run on the CPU")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the newest complete_trial* checkpoint in the log dir "
                        "(no-op on a fresh dir)")
    return p


def config(cfg, args):
    """``cfg`` cut to the smoke size, to ``--trials``, ``--opt-steps`` and
    ``--gp-epochs``, as the flags ask."""
    if args.smoke:
        cfg = cfg.smoke()
    cut = {"num_trials": args.trials, "gp_epochs": args.gp_epochs,
           "opt_steps": None if args.opt_steps is None else (args.opt_steps,)}
    return dataclasses.replace(cfg, **{k: v for k, v in cut.items() if v is not None})


def build_and_train(scen, cfg, device, auto_resume: bool, tag: str, on_resumed=None,
                    on_trial_end=None):
    """Build, optionally resume (then ``on_resumed(agent)``), train with
    ``reinforce(on_trial_end=...)`` and print the wall clock.  Returns
    (agent, number of trials resumed)."""
    agent, kwargs = scen.build(cfg, device)
    done = agent.auto_resume() if auto_resume else 0
    if done:
        print(f"[train] auto-resumed {done} completed trials from {agent.log_dir}")
        kwargs = {**kwargs, "num_trials": max(kwargs["num_trials"] - done, 0)}
        if on_resumed is not None:
            on_resumed(agent)
    t0 = time.time()
    logs = agent.reinforce(**kwargs, on_trial_end=on_trial_end)
    print(f"\n[{tag}] total wall-clock {time.time() - t0:.1f}s over {len(logs)} trials")
    return agent, done


def train(scen, cfg, device, auto_resume: bool, tag: str, angle_index: int):
    """Build, optionally resume, train, and print the result lines of the
    JAX package's scripts: the wall clock, the final trial's swing-up success
    and cumulative cost, and its last five |angle| - pi.  Returns (agent,
    number of trials resumed)."""
    agent, done = build_and_train(scen, cfg, device, auto_resume, tag)
    final = agent.trials[-1]
    print(f"[{tag}] final-trial swing-up success: {scen.swingup_success(final.true)}")
    print(f"[{tag}] final-trial cumulative cost: {agent.trial_cumulative_cost():.4f}")
    print(f"[{tag}] final trial tail |angle|-pi:",
          np.round(np.abs(np.abs(final.true[-5:, angle_index]) - np.pi), 3))
    return agent, done


def exit_code(scen, agent, args) -> int:
    """0 on a final-trial swing-up (always for ``--smoke``), else 1."""
    return 0 if (scen.swingup_success(agent.trials[-1].true) or args.smoke) else 1
