"""Quantify the 4PMS "over-rotates at low in-model cost" failure mode (the
JAX package's ``scripts/analyze_pms_bias.py``).

Along the executed final trial of a checkpoint it compares the learned
model's one-step velocity-delta predictions (the model is trained on the
offline-filtered estimates) with the deltas of (a) the filtered estimates
themselves and (b) the true plant states.  A systematic |delta|
underestimate against the true plant, concentrated where the accelerations
peak, is the model-bias signature of low-pass-filtered training data.

    python -m mcpilco_tpu_torch.scripts.analyze_pms_bias \\
        results_tmp/torch/cartpole_pms_1/complete_trial4 [--device cpu]

It prints the JAX script's lines.  ``main(argv)`` also returns the numbers
it prints, unrounded: per head (``xdot``, ``thdot``) the RMSE and bias
against the filtered data and against the true plant, the signed error and
the mean |true delta| in the top quartile of |true delta|, and the two
attenuation ratios.  Runs on the card unless ``--device cpu``.
"""

import argparse

import numpy as np
import torch

HEADS = ("xdot", "thdot")


@torch.no_grad()
def bias_numbers(agent) -> dict:
    """The per-head numbers of the analysis on a restored 4PMS agent."""
    final = agent.trials[-1]
    dev = agent.device

    def residuals(states):
        x, y = agent.model.training_pairs(
            torch.as_tensor(states, dtype=torch.float32, device=dev),
            torch.as_tensor(final.inputs, dtype=torch.float32, device=dev))
        mean, _ = agent.gp.predict(agent.gp_params, agent.posterior, x)
        return mean.cpu().numpy(), y.cpu().numpy()

    # (a) the model on its own training domain: the filtered measured states
    mean_meas, y_meas = residuals(final.measured)
    # (b) the model against the true plant: GP inputs from the true states
    mean_true, y_true = residuals(final.true[: final.inputs.shape[0]])
    out = {}
    for g, name in enumerate(HEADS):
        res_m = mean_meas[g] - y_meas[g]
        res_t = mean_true[g] - y_true[g]
        # where the true delta is large (acceleration peaks)
        big = np.abs(y_true[g]) > np.quantile(np.abs(y_true[g]), 0.75)
        out[name] = dict(
            rmse_filtered=float(np.sqrt((res_m ** 2).mean())),
            bias_filtered=float(res_m.mean()),
            rmse_true=float(np.sqrt((res_t ** 2).mean())),
            bias_true=float(res_t.mean()),
            top_quartile_signed_err=float(res_t[big].mean()),
            top_quartile_abs_true=float(np.abs(y_true[g][big]).mean()),
            # does the model under-predict the big velocity changes?
            pred_over_true=float(np.abs(mean_true[g][big]).sum() / np.abs(y_true[g][big]).sum()),
            filtered_over_true=float(np.abs(y_meas[g][big]).sum()
                                     / np.abs(y_true[g][big]).sum()),
        )
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("analyze_pms_bias")
    p.add_argument("ckpt")
    p.add_argument("--device", default="cuda", help="cpu to run on the CPU")
    args = p.parse_args(argv)

    from ..scenarios import cartpole_pms as scen

    agent, _ = scen.build(scen.CartpolePMSConfig(seed=1), args.device)
    agent.load_checkpoint(args.ckpt)
    out = bias_numbers(agent)
    print(f"checkpoint: {args.ckpt}; T={agent.trials[-1].true.shape[0]} executed samples")
    for name in HEADS:
        r = out[name]
        print(
            f"[{name}] vs filtered data: rmse {r['rmse_filtered']:.4f} "
            f"bias {r['bias_filtered']:+.4f} | vs TRUE plant: rmse "
            f"{r['rmse_true']:.4f} bias {r['bias_true']:+.4f} | "
            f"top-quartile-|delta| signed err (pred-true) {r['top_quartile_signed_err']:+.4f} "
            f"/ mean |true delta| {r['top_quartile_abs_true']:.4f}"
        )
    for name in HEADS:
        r = out[name]
        print(
            f"[{name}] top-quartile |pred|/|true| = {r['pred_over_true']:.3f}; "
            f"|filtered target|/|true| = {r['filtered_over_true']:.3f} "
            "(filtering attenuation reaching the training data)"
        )
    return out


if __name__ == "__main__":
    main()
