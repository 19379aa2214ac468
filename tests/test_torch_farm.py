"""The port's seed farm (``parallel/multiseed.SeedFarm``) against the same
seeds trained alone in the port, as tests/test_multiseed.py holds the JAX
package's farm against its sequential path.

Every stage draws from the seed's own keys, so a farmed seed trains on the
same data, fits the same GP and samples the same rollouts as the seed
trained alone; only the summation order of the batched products differs.
Tolerances: rtol / atol 5e-3 on the cost history and 5e-2 on the executed
control trial, those of tests/test_multiseed.py.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from mcpilco_tpu_torch.parallel.multiseed import SeedFarm
from mcpilco_tpu_torch.scenarios import cartpole as scen
from mcpilco_tpu_torch.scenarios import cartpole_pms as pms
from mcpilco_tpu_torch.utils import prng

torch.set_num_threads(1)


def _cfg(seed=3):
    return dataclasses.replace(scen.CartpoleConfig(seed=seed).smoke(), num_particles=32,
                               opt_steps=(12,), gp_epochs=60)


def _farm(seeds, restarts=1, **kw):
    cfg = _cfg(seed=0)
    agent, kwargs = scen.build(cfg, "cpu")
    agent.optimizer = dataclasses.replace(agent.optimizer, num_restarts=restarts)
    farm = SeedFarm(agent, seeds,
                    policy_init_fn=lambda k: scen.policy_init(cfg, agent.policy, k, "cpu"), **kw)
    return farm.run(**kwargs, verbose=False)


def _alone(seed, restarts=1):
    agent, kwargs = scen.build(_cfg(seed), "cpu")
    agent.optimizer = dataclasses.replace(agent.optimizer, num_restarts=restarts)
    agent.reinforce(**kwargs, verbose=False)
    return agent


@pytest.fixture(scope="module")
def farmed():
    ticks = []
    res = _farm([2, 3, 5], progress_cb=lambda: ticks.append(1))
    return res, ticks


def test_farmed_seed_matches_the_seed_trained_alone(farmed):
    """Seed 3 farmed among [2, 3, 5] == seed 3 trained alone."""
    res, _ = farmed
    agent = _alone(3)
    i = list(res.seeds).index(3)
    log, seq = res.trial_logs[-1], agent.trial_logs[-1]
    assert int(log.steps_done[i]) == seq.steps_done == 12
    np.testing.assert_allclose(log.cost_history[i, : seq.steps_done], seq.cost_history,
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(log.control_true[i], agent.trials[-1].true, rtol=5e-2, atol=5e-2)
    assert log.cost_history.shape == (3, 12) and log.mll_last.shape == (3,)


def test_distinct_seeds_distinct_outcomes(farmed):
    t = farmed[0].final_true
    assert t.shape == (3, 61, 4) and np.all(np.isfinite(t))
    assert not np.allclose(t[0], t[1]) and not np.allclose(t[1], t[2])


def test_progress_cb_ticks_at_host_returns(farmed):
    # exploration collect + fit + one optimization lane + control collect
    assert len(farmed[1]) == 4


def test_restart_lanes_match_sequential():
    """R=2 farms as sequential restart lanes with the sequential path's key
    derivation: seed 3 farmed with R=2 == seed 3 trained alone with R=2."""
    agent = _alone(3, restarts=2)
    log = agent.trial_logs[-1]
    assert log.restart_costs.shape == (2,) and log.restart_winner == int(
        np.argmin(log.restart_costs))
    res = _farm([2, 3], restarts=2)
    i = list(res.seeds).index(3)
    np.testing.assert_allclose(res.trial_logs[-1].control_true[i], agent.trials[-1].true,
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(res.trial_logs[-1].cost_history[i, : log.steps_done],
                               log.cost_history, rtol=5e-3, atol=5e-3)


def test_plant_lanes_match_one_rollout_per_seed():
    agent, _ = scen.build(_cfg(), "cpu")
    keys = [prng.fold(prng.root_key(s), 4) for s in (1, 2)]
    s0 = np.array([[0.0, 0.0, 0.1, 0.0], [0.2, 0.0, -0.1, 0.0]], np.float32)
    pol = {k: torch.stack([v, 0.5 * v]) for k, v in agent.policy_params.items()}
    for policy, params in ((agent.exploration_policy, {}), (agent.policy, pol)):
        lanes = agent.plant.rollout_lanes(keys, s0, policy, params, 1.0, 0.05, device="cpu")
        for i, k in enumerate(keys):
            one = agent.plant.rollout(k, s0[i], policy, {n: v[i] for n, v in params.items()},
                                      1.0, 0.05, device="cpu")
            assert lanes.true.shape == (2, 21, 4)
            for name in ("measured", "inputs", "true"):
                np.testing.assert_allclose(getattr(lanes, name)[i], getattr(one, name),
                                           rtol=1e-6, atol=1e-6, err_msg=name)


class _HostPlant:
    """A plant simulated on the host, as a MuJoCo plant is."""

    def rollout(self, key, s0, policy, policy_params, T, dt, device="cuda"):
        raise AssertionError("the farm must refuse this plant before any rollout")


class _NoRolloutPlant:
    """A plant that offers no rollout() protocol."""


@pytest.mark.parametrize("case", ["sor", "offline_filtering", "host_plant", "mesh"])
def test_farm_rejects_what_it_does_not_cover(case):
    """What the JAX package's farm refuses: SOR, a host plant with offline
    filtering (``offline_filtering``), a plant without rollout()
    (``host_plant``), an optimizer whose particle mesh the farm does not
    share (``mesh``: the farm composes with particle sharding only on one
    shared 2D ("s", "p") mesh; tests/test_torch_mesh.py runs the meshes it
    takes)."""
    if case == "offline_filtering":
        agent, _ = pms.build(pms.CartpolePMSConfig().smoke(), "cpu")
        agent.plant = _HostPlant()
    else:
        agent, _ = scen.build(_cfg(), "cpu")
    kw = {}
    if case == "sor":
        agent.sor = object()
    elif case == "host_plant":
        agent.plant = _NoRolloutPlant()
    elif case == "mesh":
        particle_mesh = types.SimpleNamespace(axis_names=("p",), shape={"p": 2})
        agent.optimizer = dataclasses.replace(agent.optimizer, mesh=particle_mesh)
    match = {"sor": "SOR", "offline_filtering": "offline filtering for a host plant",
             "host_plant": "rollout", "mesh": "mesh"}[case]
    with pytest.raises(ValueError, match=match):
        SeedFarm(agent, [1, 2], **kw)
