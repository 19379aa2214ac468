"""The policy optimizer's loop run K iterations per host read
(``control/trainer.py``): the monitor, keep-best, the histories and the lane
selection on the device, a NaN halting its lane until the chunk's read.

The problem is tests/test_torch_graph_step.py's (P=16, horizon 10, 20
basis, SE+P(2)) over 10 steps, with a monitor whose gate opens on step
counts alone (thr = 1 lies far above |dcr|): lr 0.01 -> 0.005 at step 2, ->
lr_min 0.0025 at step 5, and the lane exits at step 8; each plateau moves
the dropout rate down by 0.125 (0.25, 0.125, 0), inside a chunk.  NaN
rollouts come from fixed keys, (step, reinit + retry * 2^20 + rid * 2^26):
lane 0 NaNs at step 2 and at its re-sample, gives up and re-initializes (its
monitor restarts, so it runs all 10 steps); lane 1 NaNs once at step 4 and
its re-sample is healthy; it exits after 9 steps.

(a) ``chunk`` in {1, 3, 7} and the default give bitwise equal results for
    one and two lanes, with the same re-init keys.
(b) The host reads the lanes back once per chunk, plus where every lane
    halted: the reads and the iterations run after every lane stopped are
    counted.
(c) The lane schedule against the JAX package's compiled loop
    (``_optimize_chunk``) on the same draws, the JAX policy re-init handed
    to the port: steps, lr, dropout rate and re-inits exact; costs and
    stds rtol 1e-3, params atol 1e-5, as in tests/test_torch_graph_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import Problem, collect_data, jax_rollout_noise, padded
from mcpilco_tpu.control import trainer as jtrainer
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.utils import prng as jprng
from mcpilco_tpu_torch.control import trainer as ttrainer
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

P, T, NB = 16, 10, 20
STEPS, P_DROP, LR0 = 10, 0.25, 0.01
MONITOR = dict(num_particles=P, horizon=T, max_opt_steps=STEPS, min_diff_cost=1.0,
               num_min_diff_cost=2, min_step=1.0, lr_min=0.0025, p_drop_reduction=0.125,
               max_nan_retries=1)
NAN_KEYS = {(2, 0), (2, 1 << 20), (4, 1 << 26)}
TKEY, JKEY = tprng.root_key(5), jax.random.PRNGKey(5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _counters(k):
    """The (step, key counter) a step key folds into the root key."""
    return tuple(k[len(TKEY):])


def _nan_where_keyed(noise, k):
    if _counters(k) in NAN_KEYS:
        noise = noise._replace(state=noise.state * float("nan"))
    return noise


@pytest.fixture(scope="module")
def problem():
    prob = Problem(num_basis=NB)
    x, y, mask = padded(*collect_data(), 64)
    data = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    params, _ = jax.jit(lambda p, d: prob.jgp.fit(p, d, num_epochs=100, learning_rate=0.05))(
        prob.jgp.init_params(), data)
    post = jax.jit(prob.jgp.fit_posterior)(params, data)
    pol = prob.policy_params()
    inits = [pol, prob.jpolicy.reinit(pol, jax.random.split(
        jprng.fold(JKEY, jprng.STREAM_RESTARTS), 1)[0])]
    t_inits = [to_torch(_np(p), "cpu") for p in inits]
    topt = ttrainer.PolicyOptimizer(engine=prob.tengine, cost=prob.tcost, init_dist=prob.tinit,
                                    **MONITOR)
    return dict(prob=prob, params=params, post=post, inits=inits, t_inits=t_inits, topt=topt,
                t_gp=to_torch(_np(params), "cpu", into=tgp.GPParams),
                t_post=to_torch(_np(post), "cpu", into=tgp.Posterior))


def _stacked(pb, lanes):
    return {k: torch.stack([p[k] for p in pb["t_inits"][:lanes]]) for k in pb["t_inits"][0]}


def _own_draws(pb):
    """The port's own draws (uniforms under the dropout masks), NaN at
    ``NAN_KEYS``."""
    opt = pb["topt"]
    return lambda k: _nan_where_keyed(opt.engine.draw_noise(
        k, P, T, P_DROP, "cpu", init_dist=opt.init_dist, keep_uniforms=True), k)


def _run(pb, lanes, chunk, noise_fn, monkeypatch, reinit=None):
    """``optimize_lanes`` of the first ``lanes`` inits; returns (results,
    metric, the keys of its policy re-inits, the loop's counts)."""
    keys = []
    cls = type(pb["prob"].tpolicy)
    real = reinit or cls.reinit

    def recorded(self, params, key):
        if isinstance(key, list):  # lane-stacked params: one key per lane
            keys.extend(key)
        return real(self, params, key)

    with monkeypatch.context() as m:
        m.setattr(cls, "reinit", recorded)
        ttrainer.reset_graph_counts()
        res, metric = pb["topt"].optimize_lanes(
            [TKEY] * lanes, _stacked(pb, lanes), pb["t_gp"], pb["t_post"], STEPS, LR0, P_DROP,
            rids=list(range(lanes)), noise_fn=noise_fn, chunk=chunk)
    return res, metric, keys, dict(ttrainer.graph_counts)


def _assert_same(a, b):
    for ra, rb in zip(a, b):
        assert (ra.steps_done, ra.reinit_count, ra.final_lr, ra.final_p_dropout) == (
            rb.steps_done, rb.reinit_count, rb.final_lr, rb.final_p_dropout)
        for f in ("cost_history", "std_history", "states", "inputs"):
            assert torch.equal(getattr(ra, f), getattr(rb, f)), f
        for k in ra.policy_params:
            assert torch.equal(ra.policy_params[k], rb.policy_params[k]), k


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("lanes", [1, 2])
def test_results_are_bitwise_the_same_for_every_chunk(problem, lanes, monkeypatch):
    draws = _own_draws(problem)
    ref, ref_metric, ref_keys, _ = _run(problem, lanes, 1, draws, monkeypatch)
    # the schedule the module docstring sets out
    assert [r.steps_done for r in ref] == [10, 9][:lanes]
    assert [r.reinit_count for r in ref] == [1, 0][:lanes]
    assert [r.final_p_dropout for r in ref] == [0.0, 0.0][:lanes]
    assert [r.final_lr for r in ref] == [float(np.float32(0.0025))] * lanes
    assert ref_keys == [TKEY + (2, 1 << 20, tprng.STREAM_POLICY_INIT)]
    assert ref[0].cost_history[2] == ref[0].cost_history[1]  # the give-up logs cost_prev
    assert ref[0].std_history[2] == 0.0
    for chunk in (3, 7, None):
        res, metric, keys, _ = _run(problem, lanes, chunk, draws, monkeypatch)
        _assert_same(res, ref)
        np.testing.assert_array_equal(metric, ref_metric)
        assert keys == ref_keys


# ---------------------------------------------------------------- (b)


@pytest.mark.parametrize("chunk, reads, wasted, iterations", [
    # one read after every iteration: 10 steps less the give-up's, 2 NaNs
    (1, 11, 0, 11),
    # steps 0-2 (NaN at 2) and one more issued before the host saw the
    # halt; the re-sample (NaN), a chunk of its own; steps 3-9
    (7, 3, 1, 12),
    (None, 3, 1, 12),
    # chunks of 3: 0-2 (NaN at 2, the chunk's last); the re-sample; 3-5,
    # 6-8, 9
    (3, 5, 0, 11),
])
def test_host_reads_once_per_chunk_and_per_halt(problem, chunk, reads, wasted, iterations,
                                                monkeypatch):
    res, _, _, counts = _run(problem, 1, chunk, _own_draws(problem), monkeypatch)
    assert res[0].steps_done == STEPS and res[0].reinit_count == 1
    assert (counts["reads"], counts["wasted"], counts["uncaptured"]) == (reads, wasted,
                                                                        iterations)
    assert counts["wasted"] <= ttrainer.POLL_LAG - 1
    assert counts["captures"] == counts["replays"] == 0


def test_no_nan_reads_once_per_chunk(problem, monkeypatch):
    """Without a NaN the lanes go through in one read per chunk."""
    opt = problem["topt"]
    draws = lambda k: opt.engine.draw_noise(k, P, T, P_DROP, "cpu", init_dist=opt.init_dist)
    # both lanes exit at step 8; with chunks of 4 and 10 the host issues one
    # iteration more before it sees that
    for chunk, reads, wasted in ((4, 3, 1), (10, 1, 1), (1, 9, 0)):
        res, _, _, counts = _run(problem, 2, chunk, draws, monkeypatch)
        assert [r.steps_done for r in res] == [9, 9]
        assert (counts["reads"], counts["wasted"]) == (reads, wasted)
        assert counts["uncaptured"] == 9 + wasted


def test_chunk_must_be_positive(problem):
    pb = problem
    with pytest.raises(ValueError, match="at least one iteration"):
        pb["topt"].optimize_lanes([TKEY], _stacked(pb, 1), pb["t_gp"], pb["t_post"], 3, LR0,
                                  P_DROP, chunk=0)


# ---------------------------------------------------------------- (c)


def _jax_lanes(pb, lanes, monkeypatch):
    """The JAX compiled loop's carry for the first ``lanes`` inits (lane 1
    a restart lane), NaN at ``NAN_KEYS``."""
    prob = pb["prob"]
    jopt = jtrainer.PolicyOptimizer(engine=prob.jengine, cost=prob.jcost, init_dist=prob.jinit,
                                    num_restarts=lanes, **MONITOR)
    bad = jnp.stack([jprng.fold(JKEY, s, c) for s, c in sorted(NAN_KEYS)])
    real = jtrainer.PolicyOptimizer._rollout_cost

    def nan_where_keyed(self, params, gp_params, posterior, key, p_drop, trial_index):
        c, aux = real(self, params, gp_params, posterior, key, p_drop, trial_index)
        return jnp.where(jnp.any(jnp.all(key == bad, axis=-1)), jnp.nan, c), aux

    monkeypatch.setattr(jtrainer.PolicyOptimizer, "_rollout_cost", nan_where_keyed)
    args = (pb["params"], pb["post"], LR0, P_DROP, 0)
    # one chunk of the compiled loop (``_drive_chunks``'s body), driven
    # here: with a lane done early and the other through its steps, the min
    # over the lanes' steps stays below num_steps and ``_drive_chunks``
    # would dispatch empty chunks without end
    run = (JKEY, pb["params"], pb["post"], jnp.int32(STEPS), jnp.int32(1 << 20), 0)
    if lanes == 1:
        carry = jopt._optimize_init(JKEY, pb["inits"][0], *args, jnp.zeros((), jnp.int32))
        carry = jax.tree_util.tree_map(lambda x: x[None], jopt._optimize_chunk(carry, *run))
    else:
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pb["inits"][:lanes])
        carry = jopt._optimize_chunk_multi(jopt._optimize_init_multi(JKEY, stacked, *args),
                                           JKEY, pb["params"], pb["post"], jnp.int32(STEPS),
                                           jnp.full((lanes,), 1 << 20, jnp.int32), 0)
    return _np(carry)


@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("lanes", [1, 2])
def test_lane_schedule_matches_jax_compiled_loop(problem, lanes, chunk, monkeypatch):
    pb, prob = problem, problem["prob"]
    j = _jax_lanes(pb, lanes, monkeypatch)

    def jax_draws(k):
        noise = jax_rollout_noise(jprng.fold(JKEY, *_counters(k)), P, T, 2, NB, P_DROP,
                                  init_dim=4, keep_uniforms=True)
        return _nan_where_keyed(noise, k)

    def jax_reinit(self, params, key):
        """The JAX policy's re-init draw from the port key's counters."""
        out = []
        for i, k in enumerate(key):
            *folds, tag = _counters(k)
            jp = prob.jpolicy.reinit({n: jnp.asarray(v[i].numpy()) for n, v in params.items()},
                                     jprng.stream(jprng.fold(JKEY, *folds), tag))
            out.append(to_torch(_np(jp), "cpu"))
        return {n: torch.stack([p[n] for p in out]) for n in params}

    res, metric, _, _ = _run(pb, lanes, chunk, jax_draws, monkeypatch, reinit=jax_reinit)
    assert [r.steps_done for r in res] == list(j.step) == [10, 9][:lanes]
    assert [r.reinit_count for r in res] == list(j.reinit_count) == [1, 0][:lanes]
    assert [r.final_lr for r in res] == [float(v) for v in j.lr]
    assert [r.final_p_dropout for r in res] == [float(v) for v in j.p_drop]
    np.testing.assert_allclose(metric, j.best_cost, rtol=1e-3)
    for i, r in enumerate(res):
        np.testing.assert_allclose(r.cost_history.numpy(), j.cost_hist[i], rtol=1e-3)
        np.testing.assert_allclose(r.std_history.numpy(), j.std_hist[i], rtol=1e-3)
        for name, v in r.policy_params.items():
            want = j.best_params[name][i] if np.isfinite(j.best_cost[i]) else j.params[name][i]
            np.testing.assert_allclose(v.numpy(), want, atol=1e-5, err_msg=name)


def test_jax_dropout_uniforms_give_its_masks():
    """The uniforms handed to the port reproduce JAX's dropout masks."""
    key = jax.random.PRNGKey(3)
    u = jax_rollout_noise(key, P, T, 2, NB, P_DROP, keep_uniforms=True).keep
    mask = jax_rollout_noise(key, P, T, 2, NB, P_DROP).keep
    assert u.dtype == torch.float32 and torch.equal(u < 1.0 - P_DROP, mask)
