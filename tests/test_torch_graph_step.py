"""The optimizer's iteration as a host part and a device body
(``control/trainer.py``): on CUDA the body is captured as a CUDA graph; on
the CPU the same body runs uncaptured, so these tests hold the body itself.

(a) The body-based ``optimize`` (one host read per iteration, and one per
    3) against the JAX package's compiled loop
    (``_optimize_chunk``) at the sizes of tests/test_torch_slice.py (P=16,
    horizon 10, 20 basis, SE+P(2)), the JAX draws handed to the port, for 5
    steps with a monitor whose plateau fires at step 2: lr halves, the Adam
    moments restart and ``p_drop_reduction`` moves the dropout rate from
    0.25 to 0.125 for steps 3-4.  One lane, and two restart lanes (lane 1
    from JAX's restart draw).  Costs rtol 1e-3, params atol 1e-5, as in
    tests/test_torch_slice.py (two frameworks' float32 rounding through 10
    closed-loop steps; an Adam step moves a leaf by ~lr * sign(grad)).
(b) The body (the rollout, Adam, the monitor and the lane selection)
    draws no random number, (c) builds no tensor from host data and reads
    nothing back, run one and three iterations per host read, on the
    flagship, 4PMS, Furuta semiparametric and
    UR5 (remat) paths, the fused predict where the path has one: after the
    warm-up iterations (which may fill the per-device constant caches, as
    they do before a capture) every further body runs with
    ``prng.generator``, ``torch.tensor``, ``torch.as_tensor`` and
    ``torch.prod`` (whose backward reads the host) patched to raise and
    under a dispatch mode that refuses random, host-to-device and
    device-to-host ops.  Under a dispatch mode PyTorch takes the backward
    formulas it keeps for tensor subclasses, so a data-dependent branch of
    a backward formula shows only in the capture on the card.
(d) After a NaN, the result's states, inputs and std history are those of
    the lane's last healthy step, not of the later NaN iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import Problem, collect_data, jax_rollout_noise, padded
from mcpilco_tpu.control import trainer as jtrainer
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.utils import prng as jprng
from mcpilco_tpu_torch.control import trainer as ttrainer
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models.gp import GPData, MultiGP
from mcpilco_tpu_torch.ops import fused_predict as fp
from mcpilco_tpu_torch.scenarios import cartpole, cartpole_pms, furuta, ur5
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

P, T, NB = 16, 10, 20
P_DROP = 0.25


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def fitted():
    prob = Problem(num_basis=NB)
    x, y, mask = padded(*collect_data(), 64)
    data = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    params, _ = jax.jit(lambda p, d: prob.jgp.fit(p, d, num_epochs=100, learning_rate=0.05))(
        prob.jgp.init_params(), data)
    post = jax.jit(prob.jgp.fit_posterior)(params, data)
    return prob, params, post


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("lanes", [1, 2])
def test_body_optimize_matches_jax_compiled_loop(fitted, lanes, chunk):
    prob, params, post = fitted
    pol = prob.policy_params()
    # |dcr| stays far below thr = 1, so the plateau gate opens at the first
    # step past min_step with 2 consecutive steps below it: step 2
    kw = dict(engine=None, cost=None, init_dist=None, num_particles=P, horizon=T,
              max_opt_steps=5, min_diff_cost=1.0, num_min_diff_cost=2, min_step=1.0,
              lr_min=0.0025, p_drop_reduction=0.125)
    jopt = jtrainer.PolicyOptimizer(**dict(kw, engine=prob.jengine, cost=prob.jcost,
                                           init_dist=prob.jinit, num_restarts=lanes))
    topt = ttrainer.PolicyOptimizer(**dict(kw, engine=prob.tengine, cost=prob.tcost,
                                           init_dist=prob.tinit))
    t_gp = to_torch(_np(params), "cpu", into=tgp.GPParams)
    t_post = to_torch(_np(post), "cpu", into=tgp.Posterior)
    jkey, tkey = jax.random.PRNGKey(5), tprng.root_key(5)

    def noise_fn(k):
        # the port's step keys carry the JAX ones' counters; the rate is the
        # monitor's: 0.25 until the plateau at step 2, then 0.125 (the probe
        # key's counter 0x9999 is no step)
        counters = k[len(tkey):]
        rate = P_DROP if counters[0] == 0x9999 or counters[0] <= 2 else P_DROP - 0.125
        return jax_rollout_noise(jprng.fold(jkey, *counters), P, T, 2, NB, rate, init_dim=4)

    inits = [pol]
    if lanes > 1:
        rkey = jax.random.split(jprng.fold(jkey, jprng.STREAM_RESTARTS), 1)[0]
        inits.append(prob.jpolicy.reinit(pol, rkey))
    t_inits = [to_torch(_np(p), "cpu") for p in inits]
    stacked = {k: torch.stack([p[k] for p in t_inits]) for k in t_inits[0]}

    jres = jopt.optimize(jkey, pol, params, post, 5, 0.01, P_DROP)
    tres, metric = topt.optimize_lanes([tkey] * lanes, stacked, t_gp, t_post, 5, 0.01, P_DROP,
                                       rids=list(range(lanes)), noise_fn=noise_fn, chunk=chunk)
    winner = 0
    if lanes > 1:
        np.testing.assert_allclose(metric, np.asarray(jres.restart_costs), rtol=1e-3)
        winner = int(jres.restart_winner)
        assert int(np.argmin(metric)) == winner
    res = tres[winner]
    assert res.steps_done == int(jres.steps_done) == 5
    assert res.final_p_dropout == pytest.approx(float(jres.final_p_dropout)) == 0.125
    assert res.final_lr == pytest.approx(float(jres.final_lr)) == 0.005
    np.testing.assert_allclose(res.cost_history.numpy(), np.asarray(jres.cost_history), rtol=1e-3)
    np.testing.assert_allclose(res.std_history.numpy(), np.asarray(jres.std_history), rtol=1e-3)
    for name, v in res.policy_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jres.policy_params[name]), atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------- (b), (c)


def _agent(name):
    """A scenario's agent at full structure, its optimizer cut to P=6 and 5
    rollout steps, with a posterior on 24 random data points (initial GP
    hyperparameters): the body's operations, not its numbers, are checked."""
    if name == "flagship":
        agent, _ = cartpole.build(cartpole.CartpoleConfig(seed=1), "cpu")
    elif name == "4pms":
        agent, _ = cartpole_pms.build(cartpole_pms.CartpolePMSConfig(seed=1), "cpu")
    elif name == "furuta":
        agent, _ = furuta.build(furuta.FurutaConfig(seed=1), "cpu")
    else:
        agent, _ = ur5.build(ur5.UR5Config(seed=1), "cpu")
        assert agent.optimizer.engine.remat
    agent.optimizer = dataclasses.replace(agent.optimizer, num_particles=6, horizon=5)
    g = torch.Generator().manual_seed(0)
    n, d = 24, agent.optimizer.engine.model.gp_input_dim
    data = GPData(x=torch.randn(n, d, generator=g),
                  y=0.01 * torch.randn(agent.gp.num_heads, n, generator=g), mask=torch.ones(n))
    gp_params = agent.gp.init_params()
    return agent, gp_params, agent.gp.fit_posterior(gp_params, data)


_RANDOM_OPS = {"rand", "randn", "randint", "randperm", "normal", "uniform", "bernoulli",
               "random", "exponential", "multinomial"}
# host data into a tensor (torch.tensor, indexing with a list), a read back
# to the host, an output whose shape depends on the data (a sync)
_HOST_OPS = {"lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "nonzero", "masked_select"}


class _Refuse(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__.rstrip("_") in self.ops:
            raise AssertionError(f"the device body ran {func}")
        return func(*args, **(kwargs or {}))


def _refuse(*_, **__):
    raise AssertionError("the device body drew from a generator")


def _refuse_prod(*_, **__):
    raise AssertionError("the device body took a torch.prod, whose backward reads the host")


def _refuse_host_data(real):
    def make(data, *args, **kwargs):
        if not torch.is_tensor(data):
            raise AssertionError(f"the device body made a tensor from host data {data!r}")
        return real(data, *args, **kwargs)
    return make


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("check", ["random", "host_data"])
@pytest.mark.parametrize("path", ["flagship", "4pms", "furuta", "ur5"])
def test_body_stays_on_the_device(path, check, chunk, monkeypatch):
    agent, gp_params, post = _agent(path)
    fused = agent.gp._fused_structure() is not None
    twins = {"fwd": 0, "bwd": 0}
    if fused:
        # the card's predict: K1/K2's autograd function, which takes their
        # plain versions on the CPU (counted here)
        monkeypatch.setattr(MultiGP, "predict", MultiGP._predict_fused)
        for key, name in (("fwd", "reference_gram_contract"),
                          ("bwd", "reference_gram_contract_bwd_xstar")):
            def counted(*a, _key=key, _f=getattr(fp, name), **k):
                twins[_key] += 1
                return _f(*a, **k)
            monkeypatch.setattr(fp, name, counted)
    body, checked = ttrainer.PolicyOptimizer._body, []

    def guarded(self, *args, **kwargs):
        if len(checked) < ttrainer.GRAPH_WARMUP:
            checked.append(False)
            return body(self, *args, **kwargs)
        checked.append(True)
        with monkeypatch.context() as m:
            if check == "random":
                m.setattr(tprng, "generator", _refuse)
                mode = _Refuse(_RANDOM_OPS)
            else:
                m.setattr(torch, "tensor", _refuse_host_data(torch.tensor))
                m.setattr(torch, "as_tensor", _refuse_host_data(torch.as_tensor))
                # its backward reads the input's zero count back to the host;
                # under a dispatch mode PyTorch takes another backward, so
                # the mode alone would not see it
                m.setattr(torch, "prod", _refuse_prod)
                m.setattr(torch.Tensor, "prod", _refuse_prod)
                mode = _Refuse(_HOST_OPS)
            with mode:
                return body(self, *args, **kwargs)

    monkeypatch.setattr(ttrainer.PolicyOptimizer, "_body", guarded)
    res = agent.optimizer.optimize(tprng.root_key(3), agent.policy_params, gp_params, post, 4,
                                   0.01, 0.25, chunk=chunk)
    assert res.steps_done == 4 and checked.count(True) >= 2
    assert np.all(np.isfinite(res.cost_history[:4].numpy()))
    # K1 in the forward and K2 in the backward of every rollout step
    assert (min(twins.values()) > 0) == fused


# ---------------------------------------------------------------- (d)


@pytest.fixture(scope="module")
def small():
    prob = Problem(num_basis=NB)
    x, y, mask = padded(*collect_data(), 64)
    data = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    gp_params, _ = prob.tgp.fit(prob.tgp.init_params(), data, num_epochs=100, learning_rate=0.05)
    post = prob.tgp.fit_posterior(gp_params, data)
    pol = prob.tpolicy.init_params(tprng.root_key(1))
    opt = ttrainer.PolicyOptimizer(engine=prob.tengine, cost=prob.tcost, init_dist=prob.tinit,
                                   num_particles=P, horizon=T, max_opt_steps=10,
                                   max_nan_retries=1)
    return opt, gp_params, post, pol


@pytest.mark.parametrize("lanes", [1, 2])
def test_nan_keeps_the_last_healthy_rollout(small, lanes, monkeypatch):
    """Lane 0 turns NaN from iteration 3 on: one re-sample, then the give-up
    logs step 3 and re-initializes; with two lanes, lane 1 stays healthy,
    is done after iteration 3 and is discarded in iteration 4."""
    opt, gp_params, post, pol = small
    seen = []
    orig = ttrainer.PolicyOptimizer._rollout_cost

    def flaky(self, params, *a, **kw):
        c, (s, st, inp) = orig(self, params, *a, **kw)
        if torch.is_grad_enabled():
            seen.append((st.detach().clone(), inp.detach().clone(), s.clone()))
            if len(seen) > 3:
                c = c * torch.tensor([float("nan")] + [1.0] * (lanes - 1))
        return c, (s, st, inp)

    monkeypatch.setattr(ttrainer.PolicyOptimizer, "_rollout_cost", flaky)
    res, _ = opt.optimize_lanes([tprng.root_key(2)] * lanes,
                                {k: torch.stack([v] * lanes) for k, v in pol.items()}, gp_params,
                                post, num_opt_steps=4, lr0=0.02, p_dropout0=0.1,
                                rids=list(range(lanes)))
    assert len(seen) == 5 and res[0].steps_done == 4 and res[0].reinit_count == 1
    st, inp, std = seen[2]
    assert torch.equal(res[0].states, st[:, 0]) and torch.equal(res[0].inputs, inp[:, 0])
    np.testing.assert_array_equal(res[0].std_history[:4].numpy(),
                                  [float(seen[i][2][0]) for i in range(3)] + [0.0])
    assert res[0].cost_history[3] == res[0].cost_history[2]  # the give-up logs cost_prev
    if lanes == 2:
        st, inp, std = seen[3]
        assert res[1].steps_done == 4 and res[1].reinit_count == 0
        assert torch.equal(res[1].states, st[:, 1]) and torch.equal(res[1].inputs, inp[:, 1])
        assert not torch.equal(res[1].states, seen[4][0][:, 1])
        np.testing.assert_array_equal(res[1].std_history[:4].numpy(),
                                      [float(seen[i][2][1]) for i in range(4)])


# ---------------------------------------------------------------- the graph's bookkeeping


def test_captured_launches_count_once_per_replay():
    """Calls made while a stream captures are taken back out of the launch
    counts and added once per replay."""
    fp.reset_launches()
    fp.launches["fwd"] += 2
    with fp.CapturedLaunches() as cap:
        fp.launches["fwd"] += 3
        fp.launches["bwd"] += 3
        fp.launched_lanes["fwd"] += 12
    assert fp.launches == {"fwd": 2, "bwd": 0} and fp.launched_lanes == {"fwd": 0, "bwd": 0}
    cap.replay()
    cap.replay()
    assert fp.launches == {"fwd": 8, "bwd": 6} and fp.launched_lanes == {"fwd": 24, "bwd": 0}
    fp.reset_launches()


def test_cpu_runs_the_body_uncaptured_and_refuses_a_graph(small):
    opt, gp_params, post, pol = small
    ttrainer.reset_graph_counts()
    res = opt.optimize(tprng.root_key(2), pol, gp_params, post, 3, 0.02, 0.1)
    assert res.steps_done == 3
    counts = ttrainer.graph_counts
    assert (counts["uncaptured"], counts["captures"], counts["replays"]) == (3, 0, 0)
    assert counts["uncaptured_s"] > 0 and counts["captures_s"] == counts["replays_s"] == 0.0
    with pytest.raises(ValueError, match="CUDA device"):
        opt.optimize(tprng.root_key(2), pol, gp_params, post, 3, 0.02, 0.1, graph=True)
