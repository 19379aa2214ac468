"""Restart lanes of the port's policy optimizer (``num_restarts``), inside
the port, as tests/test_restarts.py holds the JAX package's.

R policy inits are optimized against one posterior: lane 0 from the
incoming params on the single-restart key schedule, lanes 1..R-1 from
``policy.reinit`` draws; the winner is the lane with the best in-model cost.
The lane-batched loop (``restart_vmap=True``) folds the R lanes' particles
into one predict call, the sequential mode runs R one-lane loops: the two
draw the same numbers, and differ only in the summation order of the
batched products (rtol 1e-3 on costs after 20 float32 steps through 10
closed-loop rollout steps each).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import Problem, collect_data, padded
from mcpilco_tpu_torch.control.trainer import PolicyOptimizer
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.utils import prng

torch.set_num_threads(1)

P, T, NB = 16, 10, 20


@pytest.fixture(scope="module")
def setup():
    prob = Problem(num_basis=NB)
    x, y, mask = padded(*collect_data(), 64)
    data = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    gp_params, _ = prob.tgp.fit(prob.tgp.init_params(), data, num_epochs=100, learning_rate=0.05)
    post = prob.tgp.fit_posterior(gp_params, data)
    pol = prob.tpolicy.init_params(prng.root_key(1))
    pol = dict(pol, centers=pol["centers"] * torch.tensor([3.0, 3.0, 3.0, 1.0, 1.0]))
    opt = PolicyOptimizer(engine=prob.tengine, cost=prob.tcost, init_dist=prob.tinit,
                          num_particles=P, horizon=T, max_opt_steps=30)
    return opt, gp_params, post, pol


def _run(opt, setup, seed, steps=20, **kw):
    _, gp_params, post, pol = setup
    return dataclasses.replace(opt, **kw).optimize(prng.root_key(seed), pol, gp_params, post,
                                                   num_opt_steps=steps, lr0=0.02, p_dropout0=0.1)


def test_lane0_matches_single_restart(setup):
    """Lane 0 keeps the single-restart schedule: run on its own (sequential
    mode) it IS the single run; lane-batched, it agrees to rounding."""
    opt = setup[0]
    r1 = _run(opt, setup, 0)
    assert r1.restart_costs is None and r1.restart_winner is None
    best1 = float(np.min(r1.cost_history.numpy()[: r1.steps_done]))
    seq = _run(opt, setup, 0, num_restarts=3, restart_vmap=False)
    assert seq.restart_costs.shape == (3,)
    assert seq.restart_costs[0] == best1
    vm = _run(opt, setup, 0, num_restarts=3)
    np.testing.assert_allclose(vm.restart_costs[0], best1, rtol=1e-3)


def test_sequential_mode_matches_vmapped_lanes(setup):
    opt = setup[0]
    rv = _run(opt, setup, 4, num_restarts=3)
    rs = _run(opt, setup, 4, num_restarts=3, restart_vmap=False)
    np.testing.assert_allclose(rs.restart_costs, rv.restart_costs, rtol=1e-3)
    assert rs.restart_winner == rv.restart_winner
    assert rs.steps_done == rv.steps_done
    np.testing.assert_allclose(rs.cost_history.numpy(), rv.cost_history.numpy(), rtol=1e-3)
    for k, v in rs.policy_params.items():
        np.testing.assert_allclose(v.numpy(), rv.policy_params[k].numpy(), rtol=1e-2, atol=1e-3,
                                   err_msg=k)


def test_winner_is_argmin_and_histories_consistent(setup):
    r = _run(setup[0], setup, 1, num_restarts=3)
    costs, w = r.restart_costs, r.restart_winner
    assert w == int(np.argmin(costs))
    # the returned history is the winner's: its minimum is the winning cost
    hist = r.cost_history.numpy()[: r.steps_done]
    assert float(np.min(hist)) == pytest.approx(float(costs[w]), rel=1e-6)
    # the lanes differ (reinit draws and lane-distinct noise)
    assert len(np.unique(np.round(costs, 5))) == 3


def test_restart_inits_come_from_the_restart_stream(setup):
    """Lane r starts from policy.reinit(params, split(fold(key,
    STREAM_RESTARTS), R - 1)[r - 1]): with no steps and keep_best off, the
    winner (by its probe cost) returns its init."""
    pol = setup[3]
    r = _run(setup[0], setup, 9, steps=0, num_restarts=3, keep_best=False)
    assert r.steps_done == 0 and np.all(np.isfinite(r.restart_costs))
    rkeys = prng.split(prng.fold(prng.root_key(9), prng.STREAM_RESTARTS), 2)
    inits = [pol] + [setup[0].engine.policy.reinit(pol, k) for k in rkeys]
    for k in pol:
        assert torch.equal(r.policy_params[k], inits[r.restart_winner][k])
    assert not torch.equal(inits[1]["centers"], inits[2]["centers"])


def test_nan_lane_retries_and_reinits_alone(setup, monkeypatch):
    """A lane whose cost is NaN re-samples, then re-initializes, without
    touching the other lanes."""
    opt, gp_params, post, pol = setup
    calls = []
    orig = PolicyOptimizer._rollout_cost

    def flaky(self, params, *a, **kw):
        c, aux = orig(self, params, *a, **kw)
        if torch.is_grad_enabled() and c.dim() == 1:
            calls.append(None)
            c = c * torch.tensor([1.0, float("nan")])  # lane 1 is NaN at every step
        return c, aux

    opt2 = dataclasses.replace(opt, num_restarts=2, max_nan_retries=2)
    ref = _run(opt, setup, 5, steps=6)
    monkeypatch.setattr(PolicyOptimizer, "_rollout_cost", flaky)
    res, metric = opt2.optimize_lanes(
        [prng.root_key(5)] * 2, {k: torch.stack([v] * 2) for k, v in pol.items()}, gp_params,
        post, num_opt_steps=6, lr0=0.02, p_dropout0=0.1, rids=[0, 0])
    # lane 0 advanced every iteration; lane 1 logged a re-init every 3rd
    # NaN (two re-samples, then the give-up) and went on alone once lane 0
    # was done.  Iterations: the first chunk's 6 (lane 1 halted in its
    # first, its re-samples 2 more); then per step of lane 1 its NaN, the
    # iteration the host issued before it saw the halt (none in the last
    # step's chunk, of one step) and each re-sample, a chunk of its own
    assert res[0].steps_done == res[1].steps_done == 6
    assert res[0].reinit_count == 0 and res[1].reinit_count == 6
    assert len(calls) == 6 + 2 + 4 * 4 + 3 and not np.isfinite(metric[1])
    assert np.all(res[1].cost_history.numpy()[1:6] == 0.0)
    np.testing.assert_allclose(res[0].cost_history.numpy()[:6], ref.cost_history.numpy()[:6],
                               rtol=1e-3)
