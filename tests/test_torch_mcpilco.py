"""The ``MCPilco`` pieces that outcome runs need, against the JAX package:
trial scoring by control-trial ordinal (with the per-trial cost schedule
clamped to its last row, as a JAX gather clamps), the ``on_trial_end``
hook, and the GP init overrides, which the seed farm honours too.

Costs in float32 on the same numbers: rtol 1e-6.  GP init parameters: rtol
1e-6 (a float32 log in each framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpilco_tpu.envs.plants import TrialData as JTrialData
from mcpilco_tpu.models import costs as jcosts
from mcpilco_tpu.scenarios import cartpole as jcp
from mcpilco_tpu_torch.control.mc_pilco import ModelFitOptions
from mcpilco_tpu_torch.envs.plants import TrialData
from mcpilco_tpu_torch.models import costs as tcosts
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.parallel.multiseed import SeedFarm
from mcpilco_tpu_torch.scenarios import cartpole as tcp
from mcpilco_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SCHEDULE = dict(target_state=(np.pi, 0.0), lengthscales=np.array([[6.0, 2.0], [3.0, 1.0]]),
                angle_index=2, per_trial=True)
OVERRIDES = [{"lengthscales": 2.0, "outputscale": 0.5},
             {"lengthscales": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], "mean": 0.25}]


def _tiny(mod, **kw):
    return dataclasses.replace(mod.CartpoleConfig(seed=3).smoke(), num_particles=16,
                               opt_steps=(3,), gp_epochs=30, num_basis=10, **kw)


def _trials(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-3, 3, (12, 4)).astype(np.float32),
             rng.uniform(-10, 10, (12, 1)).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("trial_index", [0, 1, 4])
def test_per_trial_cost_clamps_to_the_last_row(trial_index):
    """Past the schedule, the last row's cost (a JAX gather clamps); no
    IndexError."""
    states, inputs = _trials(1)[0]
    want = jcosts.CartPoleCost(**SCHEDULE).stage_costs(
        jnp.asarray(states[:, None]), jnp.asarray(inputs[:, None]), trial_index)
    got = tcosts.CartPoleCost(**SCHEDULE).stage_costs(
        torch.as_tensor(states[:, None]), torch.as_tensor(inputs[:, None]), trial_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if trial_index == 4:
        row1 = tcosts.CartPoleCost(target_state=(np.pi, 0.0), lengthscales=(3.0, 1.0))
        np.testing.assert_allclose(got.numpy(), row1.stage_costs(
            torch.as_tensor(states[:, None]), None).numpy(), rtol=1e-6)


@pytest.mark.parametrize("num_trials", [3, 4])
def test_trial_cumulative_cost_matches_jax(num_trials):
    """After 1 exploration and 2 (or 3) control trials, every trial scored
    with its control ordinal's row: trial_cumulative_cost(-1) of the 3-trial
    case takes row 1, not row 2, and the 4-trial case clamps."""
    tagent, _ = tcp.build(_tiny(tcp), "cpu")
    jagent, _ = jcp.build(_tiny(jcp))
    tagent.cost = tcosts.CartPoleCost(**SCHEDULE)
    jagent.cost = jcosts.CartPoleCost(**SCHEDULE)
    pairs = _trials(num_trials)
    tagent.trials = [TrialData(measured=s, inputs=u, true=s, noisy=s) for s, u in pairs]
    jagent.trials = [JTrialData(measured=s, inputs=u, true=s, noisy=s) for s, u in pairs]
    tagent.num_exploration_trials = jagent.num_exploration_trials = 1
    for i in range(-num_trials, num_trials):
        np.testing.assert_allclose(tagent.trial_cumulative_cost(i),
                                   jagent.trial_cumulative_cost(i), rtol=1e-6, err_msg=str(i))
    s, u = pairs[-1]
    rows = [float(torch.sum(tagent.cost.stage_costs(torch.as_tensor(s[:, None]), None, r)))
            for r in (0, 1)]
    got = tagent.trial_cumulative_cost(-1)
    assert abs(got - rows[1]) < 1e-4 * rows[1] and abs(got - rows[0]) > 1e-2


def test_on_trial_end_runs_once_per_trial():
    agent, kwargs = tcp.build(_tiny(tcp), "cpu")
    calls = []
    agent.reinforce(**{**kwargs, "num_trials": 2}, verbose=False,
                    on_trial_end=lambda a, t: calls.append((a, t, len(a.trial_logs),
                                                            a.num_collections)))
    assert calls == [(agent, 0, 1, 2), (agent, 1, 2, 3)]


def _record_init(monkeypatch):
    seen = []
    init = tgp.MultiGP.init_params

    def recording(self, *a, **k):
        seen.append(k.get("per_head_overrides"))
        return init(self, *a, **k)

    monkeypatch.setattr(tgp.MultiGP, "init_params", recording)
    return seen


def test_gp_init_overrides_match_jax(monkeypatch):
    """The overrides give JAX's init parameters, leaf by leaf, and
    ``fit_model`` starts every fit from them."""
    tagent, _ = tcp.build(_tiny(tcp), "cpu")
    jagent, _ = jcp.build(_tiny(jcp))
    tagent.gp_init_overrides = jagent.gp_init_overrides = OVERRIDES
    want = {tuple(getattr(p, "key", getattr(p, "name", None)) for p in path): np.asarray(l)
            for path, l in jax.tree_util.tree_flatten_with_path(jagent.gp.init_params(
                sigma_n=0.5, per_head_overrides=OVERRIDES))[0]}
    tagent.gp_sigma_n_init = 0.5
    got = {p: l.numpy() for p, l in tckpt.flatten_with_path(tagent._init_gp_params())}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=str(k))
    seen = _record_init(monkeypatch)
    tagent.collect(3.0, trial_index=0, exploration=True)
    tagent.fit_model(ModelFitOptions(num_epochs=2))
    assert seen == [OVERRIDES]


def test_seed_farm_honours_gp_init_overrides(monkeypatch):
    cfg = _tiny(tcp)
    agent, _ = tcp.build(cfg, "cpu")
    agent.gp_init_overrides = OVERRIDES
    farm = SeedFarm(agent, [1, 2],
                    policy_init_fn=lambda k: tcp.policy_init(cfg, agent.policy, k, "cpu"))
    farm.collect(3.0, trial_index=0, exploration=True)
    seen = _record_init(monkeypatch)
    farm.fit_model(ModelFitOptions(num_epochs=2))
    assert seen == [OVERRIDES]
    ls = farm.gp_params.kernel["log_lengthscales"]
    assert ls.shape[:2] == (2, 2)  # seeds, heads
