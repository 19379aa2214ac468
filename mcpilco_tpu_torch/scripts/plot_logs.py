"""Plot learning curves, executed trajectories and UR5 tracking errors from a
log dir's checkpoints (the JAX package's ``scripts/plot_logs.py``, the
counterpart of the reference's log_plot_cartpole.py,
log_plot_cartpole_mujoco.py and log_plot_ur5.py):

- the policy optimization's cost curve per trial,
- the executed trajectories per trial (theta and x for the cart-poles),
- for UR5 (``--scenario ur5``) the per-joint tracking error in degrees of
  the final trial, and its joint angles as a CSV.

    python -m mcpilco_tpu_torch.scripts.plot_logs results_tmp/torch/cartpole_1
    python -m mcpilco_tpu_torch.scripts.plot_logs <log dir> --scenario ur5 --out plots/

It reads the newest ``complete_trial*`` (else ``policy_trial*``)
checkpoint of either package, with numpy only, and writes PNGs beside it
(or into ``--out``).  matplotlib is imported in :func:`main`, with the Agg
backend: nothing else of the port needs it.  ``main(argv)`` returns the
paths it wrote.
"""

import argparse
import json
import os

import numpy as np


def _trial_num(d):
    # numeric trial order: a lexicographic sort puts complete_trial10 before
    # complete_trial2 and would plot a stale checkpoint past 10 trials
    tail = d.rsplit("trial", 1)[-1]
    return int(tail) if tail.isdigit() else -1


def newest_stage(log_dir: str) -> str:
    """The newest ``complete_trial*`` checkpoint's name, else the newest
    ``policy_trial*``'s."""
    for prefix in ("complete_trial", "policy_trial"):
        stages = sorted((d for d in os.listdir(log_dir) if d.startswith(prefix)), key=_trial_num)
        if stages:
            return stages[-1]
    raise SystemExit(f"no checkpoints in {log_dir}")


def main(argv=None) -> list:
    p = argparse.ArgumentParser("plot logs")
    p.add_argument("log_dir", help="training log dir holding stage checkpoints")
    p.add_argument("--scenario", default="cartpole",
                   choices=["cartpole", "cartpole_pms", "cartpole_mujoco", "ur5"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    last = os.path.join(args.log_dir, newest_stage(args.log_dir))
    with open(os.path.join(last, "manifest.json")) as f:
        meta = json.load(f)["meta"]
    out_dir = args.out or args.log_dir
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def save(fig, name):
        path = os.path.join(out_dir, name)
        fig.savefig(path, dpi=120)
        plt.close(fig)
        print(f"wrote {path}")
        written.append(path)

    if "num_trial_logs" in meta:  # checkpoints with the full trial logs
        costs = []
        for i in range(int(meta["num_trial_logs"])):
            data = np.load(os.path.join(last, f"trial_log_{i}.npz"))
            # dict leaves are stored by sorted key: cost, p_inputs, p_states, std
            steps = int(meta["trial_log_scalars"][i]["steps_done"])
            costs.append(np.asarray(data["leaf_0"])[:steps])
    else:  # older checkpoints: the cost histories in the metadata
        costs = [np.asarray(c) for c in meta["cost_histories"]]
    true_trials = [np.asarray(t) for t in meta["trial_true"]]

    # ---- learning curves (log_plot_cartpole.py:55-103)
    fig, ax = plt.subplots(1, 1, figsize=(7, 4))
    off = 0
    for i, c in enumerate(costs):
        ax.plot(np.arange(off, off + len(c)), c, label=f"trial {i}")
        off += len(c)
    ax.set_xlabel("policy optimization step")
    ax.set_ylabel("expected cumulative cost")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    save(fig, "learning_curves.png")

    # ---- the executed trajectories per trial
    angle_ix = {"cartpole": 2, "cartpole_pms": 2, "cartpole_mujoco": 1}.get(args.scenario)
    if angle_ix is not None:
        fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        for i, t in enumerate(true_trials):
            tt = np.arange(len(t))
            axes[0].plot(tt, t[:, angle_ix], label=f"trial {i}")
            axes[1].plot(tt, t[:, 0])
        tgt = 0.0 if args.scenario == "cartpole_mujoco" else np.pi
        for sgn in (+1, -1):
            axes[0].axhline(sgn * tgt, color="k", ls="--", lw=0.7)
        axes[0].set_ylabel("theta [rad]")
        axes[1].set_ylabel("x [m]")
        axes[1].set_xlabel("step")
        axes[0].legend(fontsize=7)
        for a in axes:
            a.grid(True, alpha=0.3)
        fig.tight_layout()
        save(fig, "trajectories.png")

    # ---- UR5's per-joint tracking error in degrees (log_plot_ur5.py:122-150)
    if args.scenario == "ur5":
        from ..envs.trajectories import ur5_joint_trajectory

        final = true_trials[-1]
        traj = ur5_joint_trajectory(num_steps=len(final), dt=meta.get("dt", 0.02))
        err = (final[:, :6] - traj[: len(final), :6]) * 180.0 / np.pi
        fig, ax = plt.subplots(figsize=(8, 4))
        for j in range(6):
            ax.plot(err[:, j], label=f"joint {j}")
        ax.set_ylabel("tracking error [deg]")
        ax.set_xlabel("step")
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        save(fig, "tracking_error.png")
        # the final trial's joint angles (log_plot_ur5.py:60-63)
        csv = os.path.join(out_dir, "q_final_trial.csv")
        np.savetxt(csv, final[:, :6], delimiter=",")
        print(f"wrote {csv}")
        written.append(csv)
    return written


if __name__ == "__main__":
    main()
