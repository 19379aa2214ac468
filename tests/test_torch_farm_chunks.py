"""The seed farm's chunk control (``SeedFarm.chunk_steps_override`` and the
first-chunk rule of ``mcpilco_tpu/parallel/multiseed.py:478-481``), on the
CPU: the chunks decide only when the host reads the lanes back, so every
number is bitwise that of the default farm; ``progress_cb`` ticks at every
read."""

import dataclasses

import numpy as np
import pytest
import torch

from mcpilco_tpu_torch.control import trainer
from mcpilco_tpu_torch.parallel.multiseed import SeedFarm, first_chunk_steps
from mcpilco_tpu_torch.scenarios import cartpole as scen

torch.set_num_threads(1)

STEPS = 12


def _run(seeds, opt_steps=STEPS, chunk_steps=None, **farm_kw):
    """A smoke-width farm of 1 trial; returns (result, ticks, host reads)."""
    cfg = dataclasses.replace(scen.CartpoleConfig(seed=0).smoke(), num_particles=16,
                              num_basis=10, opt_steps=(opt_steps,), gp_epochs=30)
    agent, kwargs = scen.build(cfg, "cpu")
    # no adaptation: every chunk after the first is the first's size
    agent.optimizer = dataclasses.replace(agent.optimizer, chunk_target_s=0.0,
                                          **({"chunk_steps": chunk_steps} if chunk_steps else {}))
    ticks = []
    farm = SeedFarm(agent, seeds,
                    policy_init_fn=lambda k: scen.policy_init(cfg, agent.policy, k, "cpu"),
                    progress_cb=lambda: ticks.append(1), **farm_kw)
    trainer.reset_graph_counts()
    res = farm.run(**kwargs, verbose=False)
    return res, len(ticks), trainer.graph_counts["reads"]


@pytest.fixture(scope="module")
def default_farm():
    return _run([2, 3])


@pytest.mark.parametrize("override", [5, 12])
def test_override_is_bitwise_the_default_farm(default_farm, override):
    """K = 5 splits the 12 steps unevenly (5, 5, 2): 3 reads; K = 12 one."""
    res, ticks, reads = _run([2, 3], chunk_steps_override=override)
    ref, ref_ticks, ref_reads = default_farm
    assert reads == -(-STEPS // override) and ref_reads == 1
    # 2 collections and 1 fit besides the reads
    assert ticks == reads + 3 and ref_ticks == ref_reads + 3
    for a, b in zip(res.trial_logs, ref.trial_logs):
        np.testing.assert_array_equal(a.cost_history, b.cost_history)
        np.testing.assert_array_equal(a.steps_done, b.steps_done)
        np.testing.assert_array_equal(a.control_true, b.control_true)
    for k in ref.policy_params:
        assert torch.equal(res.policy_params[k], ref.policy_params[k]), k


@pytest.mark.parametrize("chunk_steps, seeds, horizon, want",
                         [(500, 4, 60, 250), (500, 1, 60, 1000), (500, 8, 150, 50),
                          (500, 16, 150, 25)])
def test_first_chunk_rule_gives_the_jax_numbers(chunk_steps, seeds, horizon, want):
    assert first_chunk_steps(chunk_steps, seeds, horizon) == want


@pytest.mark.parametrize("seeds, reads", [([2, 3], 1), ([2, 3, 5], 2)])
def test_first_chunk_follows_the_rule(seeds, reads):
    """chunk_steps 40 at horizon 60: a first chunk of 40 for two seeds (one
    read of the 40 steps; the optimizer's own budget, 40 // 2 -> 25, would
    read twice) and of 26 for three (two reads)."""
    assert first_chunk_steps(40, len(seeds), 60) == (40 if len(seeds) == 2 else 26)
    _, ticks, got = _run(seeds, opt_steps=40, chunk_steps=40)
    assert got == reads and ticks == reads + 3


def test_jax_style_construction():
    """``SeedFarm(agent, seeds, policy_init_fn=..., chunk_steps_override=40)``
    as the JAX package's ``scripts/profile_farm.py:57`` calls it."""
    cfg = scen.CartpoleConfig(seed=1).smoke()
    agent, _ = scen.build(cfg, "cpu")
    farm = SeedFarm(agent, [1, 2],
                    policy_init_fn=lambda k: scen.policy_init(cfg, agent.policy, k, "cpu"),
                    chunk_steps_override=40)
    assert farm.chunk_steps_override == 40 and farm.progress_cb is None
    assert [f.name for f in dataclasses.fields(SeedFarm)] == [
        "agent", "seeds", "mesh", "policy_init_fn", "chunk_steps_override", "progress_cb"]
