"""The port's entry scripts, run as ``python -m mcpilco_tpu_torch.scripts.<name>``:
``train_cartpole``, ``train_cartpole_pms``, ``train_furuta``,
``train_cartpole_mujoco``, ``train_ur5`` (train, checkpoint and resume),
``apply_policy`` (replay a checkpoint on the plant or the model),
``repeat`` (the multi-seed outcome protocol), ``summarize_results`` (its
outcomes beside the JAX package's), ``profile_opt`` (the flagship's
optimizer step, graphed and uncaptured), ``profile_farm`` (the seed farm
per batch size) and ``bench_particle_scaling`` (the step per particle
count)."""
