"""Does the JAX package at the commit of its Furuta record compute what
today's JAX package computes?  Runs one Furuta seed through
``MCPilco.reinforce`` of the ``mcpilco_tpu`` found on ``PYTHONPATH`` on the
CPU, writes its trial logs, and compares two such runs.

Export each package with ``git archive`` (never a checkout of an old
commit in the working tree), then run the seed in each and compare:

    git archive 8611fec mcpilco_tpu | tar -x -C /tmp/jax_8611fec
    git archive HEAD mcpilco_tpu | tar -x -C /tmp/jax_head
    PYTHONPATH=/tmp/jax_8611fec python tests/jax_furuta_record_check.py run old.npz
    PYTHONPATH=/tmp/jax_head python tests/jax_furuta_record_check.py run now.npz
    PYTHONPATH=/tmp/jax_head python tests/jax_furuta_record_check.py run now_where.npz \\
        --nan-style where
    python tests/jax_furuta_record_check.py compare old.npz now.npz

``run`` takes ``FurutaConfig(seed=5)`` at its full width (P=400, horizon
150, 200 basis functions, 1501-epoch fits), cut to 2 trials of 300
optimizer steps by default; ``--nan-style`` sets today's
``PolicyOptimizer.nan_branch_style`` (the package at the record has one
style only, the computed merge that is today's ``"where"``).  The JAX
package's ``reinforce`` does not run under ``jax_enable_x64`` (its plant's
RK4 scan carries float32), so the runs are float32, where the CPU's XLA
program is deterministic: equal programs give equal bits.  ``compare``
prints, per logged array, whether the two runs are bitwise equal and
otherwise the first entry that differs.
"""

import argparse
import os
import sys
import time

import numpy as np


def run(out, seed=5, trials=2, steps=300, epochs=1501, nan_style=None):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import mcpilco_tpu
    from mcpilco_tpu.models import gp as gpmod
    from mcpilco_tpu.scenarios import furuta

    print("package", os.path.dirname(mcpilco_tpu.__file__), flush=True)
    fit_losses = []
    fit = gpmod.MultiGP.fit

    def recorded_fit(self, *args, **kw):
        params, losses = fit(self, *args, **kw)
        fit_losses.append(np.asarray(losses))
        return params, losses

    gpmod.MultiGP.fit = recorded_fit
    cfg = furuta.FurutaConfig(seed=seed, num_trials=trials, opt_steps=(steps,) * trials,
                              gp_epochs=epochs)
    agent, kw = furuta.build(cfg)
    if nan_style:
        agent.optimizer = dataclasses.replace(agent.optimizer, nan_branch_style=nan_style)
    t0 = time.time()
    logs = agent.reinforce(**kw)
    rows = {"wall_s": np.float64(time.time() - t0)}
    for i, log in enumerate(logs):
        rows.update({f"cost_{i}": np.asarray(log.cost_history),
                     f"std_{i}": np.asarray(log.std_history),
                     f"steps_{i}": np.int64(log.steps_done),
                     f"reinit_{i}": np.int64(log.reinit_count)})
    rows.update({f"fit_{i}": v for i, v in enumerate(fit_losses)})
    for i, trial in enumerate(agent.trials):
        rows.update({f"trial_meas_{i}": np.asarray(trial.measured),
                     f"trial_u_{i}": np.asarray(trial.inputs)})
    for j, leaf in enumerate(jax.tree_util.tree_leaves(agent.policy_params)):
        rows[f"policy_{j}"] = np.asarray(leaf)
    np.savez(out, **rows)
    print(f"wall {float(rows['wall_s']):.1f} s; steps {[int(l.steps_done) for l in logs]}; "
          f"reinits {[int(l.reinit_count) for l in logs]}; final costs "
          f"{[float(l.cost_history[-1]) for l in logs]}", flush=True)


def compare(a_path, b_path):
    """Per array: bitwise equal, or the first entry that differs (flattened)
    and the largest difference.  Returns whether every array is equal."""
    a, b = np.load(a_path), np.load(b_path)
    same = True
    for k in sorted(set(a.files) & set(b.files) - {"wall_s"}):
        x, y = a[k], b[k]
        if x.shape == y.shape and np.array_equal(x, y):
            print(f"{k}: bitwise equal {x.shape}")
            continue
        same = False
        if x.shape != y.shape:
            print(f"{k}: shapes {x.shape} / {y.shape}")
            continue
        d = np.abs(x - y).ravel()
        i = int(np.argmax(d > 0))
        print(f"{k}: first differs at {i} of {d.size}: {x.ravel()[i]!r} / {y.ravel()[i]!r}; "
              f"largest difference {d.max():.6g}")
    print(f"wall s: {float(a['wall_s']):.1f} / {float(b['wall_s']):.1f}")
    return same


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="one seed through the JAX package on PYTHONPATH")
    r.add_argument("out")
    r.add_argument("--seed", type=int, default=5)
    r.add_argument("--trials", type=int, default=2)
    r.add_argument("--steps", type=int, default=300)
    r.add_argument("--epochs", type=int, default=1501)
    r.add_argument("--nan-style", default=None)
    c = sub.add_parser("compare", help="two runs' logs, array by array")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "run":
        run(args.out, args.seed, args.trials, args.steps, args.epochs, args.nan_style)
        return 0
    return 0 if compare(args.a, args.b) else 1


if __name__ == "__main__":
    sys.exit(main())
