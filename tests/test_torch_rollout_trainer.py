"""The port's rollout and policy optimizer against the JAX package.

- The mean rollout (no next-state noise, no dropout) runs in float64:
  rtol 1e-9 on states and inputs.
- The noisy rollout runs in float32 with the JAX draws reproduced here and
  handed to the port: cost and d(cost)/d(every policy leaf) to rtol 1e-3.
  BPTT through 10 closed-loop steps of GP dynamics and policy compounds the
  float32 rounding of two frameworks that sum in different orders, and the
  gradient is a sum over particles of terms that partly cancel.
- The convergence monitor and plateau logic (``PolicyOptimizer.
  monitor_update``, float32 on the device as the JAX loop carries it) run
  against scripted costs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import Problem, collect_data, jax_rollout_noise, padded
from mcpilco_tpu.control import rollout as jroll
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu_torch.control import rollout as troll
from mcpilco_tpu_torch.control.trainer import Monitor, PolicyOptimizer
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

P, T, NB = 12, 10, 20


def _setup(dtype):
    prob = Problem(num_basis=NB)
    x, y = collect_data()
    x, y, mask = padded(x.astype(dtype), y.astype(dtype), 64)
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    params = prob.jgp.init_params(sigma_n=0.05, dtype=jdtype)
    post = jax.jit(prob.jgp.fit_posterior)(
        params, jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask)))
    pol = prob.policy_params(dtype=jdtype)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    t = dict(gp=to_torch(np_tree(params), "cpu", into=tgp.GPParams),
             post=to_torch(np_tree(post), "cpu", into=tgp.Posterior),
             pol=to_torch(np_tree(pol), "cpu"))
    s0 = 0.1 * np.random.default_rng(0).standard_normal((P, 4)).astype(dtype)
    return prob, params, post, pol, t, s0


def test_mean_rollout_matches_jax(x64):
    prob, params, post, pol, t, s0 = _setup(np.float64)
    key = jax.random.PRNGKey(0)
    rj = jax.jit(lambda p: prob.jengine.simulate(key, p, params, post, jnp.asarray(s0), T,
                                                 particle_pred=False))(pol)
    noise = jax_rollout_noise(key, P, T, 2, NB, 0.0, dtype=jnp.float64)
    rt = prob.tengine.simulate(None, t["pol"], t["gp"], t["post"], torch.as_tensor(s0), T,
                               p_dropout=0.0, particle_pred=False, noise=noise)
    np.testing.assert_allclose(rt.states.numpy(), np.asarray(rj.states), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rt.inputs.numpy(), np.asarray(rj.inputs), rtol=1e-9, atol=1e-12)
    assert rt.states.shape == (T, P, 4) and rt.inputs.shape == (T, P, 1)
    # the trajectory moves: the test is not comparing constants
    assert float(torch.abs(rt.states[-1] - rt.states[0]).max()) > 1e-2


def test_noisy_rollout_cost_and_gradient_match_jax():
    prob, params, post, pol, t, s0 = _setup(np.float32)
    key = jax.random.PRNGKey(3)
    p_drop = 0.25

    def cost_j(pp):
        res = prob.jengine.simulate(key, pp, params, post, jnp.asarray(s0), T, p_dropout=p_drop)
        return prob.jcost(res.states, res.inputs)[0]

    cj, gj = jax.jit(jax.value_and_grad(cost_j))(pol)
    noise = jax_rollout_noise(key, P, T, 2, NB, p_drop)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t["pol"].items()}
    res = prob.tengine.simulate(None, leaves, t["gp"], t["post"], torch.as_tensor(s0), T,
                                p_dropout=p_drop, noise=noise)
    ct, _ = prob.tcost(res.states, res.inputs)
    gt = torch.autograd.grad(ct, list(leaves.values()))
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-3)
    for name, g in zip(leaves, gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(np.asarray(gj[name])).max()),
                                   err_msg=name)


def test_clip_bptt_matches_jax():
    """Identity forward; the backward clips each particle's cotangent norm."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    g = (rng.standard_normal((6, 4)) * np.logspace(-2, 2, 6)[:, None]).astype(np.float32)
    yj, vjp = jax.vjp(lambda a: jroll._clip_bptt(a, 1.5), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt = troll._clip_bptt(xt, 1.5)
    (gt,) = torch.autograd.grad(yt, xt, torch.as_tensor(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)
    assert np.all(np.linalg.norm(gt.numpy(), axis=-1) <= 1.5 * (1 + 1e-6))


def _monitor(**kw):
    """A one-lane device monitor and the optimizer whose config drives it."""
    base = dict(alpha=0.99, num_min_diff_cost=5, min_step=3.0, lr_reduction_ratio=0.5,
                lr_min=0.0025, p_drop_reduction=0.125, thr_floor=0.01, lr=0.01, p_drop=0.25,
                thr=0.08)
    base.update(kw)
    opt = PolicyOptimizer(engine=None, cost=None, init_dist=None, num_particles=1, horizon=1,
                          max_opt_steps=1, alpha_diff_cost=base["alpha"],
                          min_diff_cost=base["thr"], num_min_diff_cost=base["num_min_diff_cost"],
                          min_step=base["min_step"], lr_reduction_ratio=base["lr_reduction_ratio"],
                          lr_min=base["lr_min"], p_drop_reduction=base["p_drop_reduction"],
                          thr_floor=base["thr_floor"])
    f32 = lambda v: torch.tensor([v], dtype=torch.float32)
    mon = Monitor(lr=f32(base["lr"]), p_drop=f32(base["p_drop"]), thr=f32(base["thr"]),
                  gate_step=f32(base["min_step"]), consec=torch.zeros(1, dtype=torch.int32),
                  es1=f32(0.0), es2=f32(0.0), dcr=f32(0.0))
    return opt, mon


def _update(opt, mon, step, dc):
    mon, reduce_lr, exit_now = opt.monitor_update(
        mon, torch.tensor([step], dtype=torch.int32), torch.tensor([dc], dtype=torch.float32))
    return mon, bool(reduce_lr[0]), bool(exit_now[0])


def test_monitor_plateau_schedule_on_flat_costs():
    """Flat costs: dcr stays 0, so every step counts as a plateau step; the
    lr halves once the gate passes, then again num_min_diff_cost steps
    later, and the loop exits at lr_min.  The schedule's values are float32
    (the halvings are exact)."""
    opt, mon = _monitor()
    events = []
    for step in range(40):
        mon, reduce_lr, exit_now = _update(opt, mon, step, 0.0)
        if reduce_lr or exit_now:
            events.append((step, reduce_lr, exit_now, float(mon.lr[0]), float(mon.p_drop[0]),
                           float(mon.thr[0])))
        if exit_now:
            break
    f32 = lambda v: float(np.float32(v))
    # first reduction: consec reaches 5 at step 4, the gate needs step > 3
    assert events[0] == (4, True, False, f32(0.005), 0.125, f32(0.04))
    # then the gate moves to step 4 + 5 and consec restarts: consec is 6 at
    # step 10, the first step past the gate; lr reaches lr_min there
    assert events[1] == (10, True, False, f32(0.0025), 0.0, f32(0.02))
    # at lr_min the next plateau (gate at 15) ends the loop
    assert events[2][:3] == (16, False, True)
    assert len(events) == 3


def test_monitor_matches_reference_recursion_on_noisy_costs():
    """The monitor's smoothed statistics follow the reference recursion
    (MC_PILCO.py:507-519) step by step, in float32 as the JAX loop computes
    it (mcpilco_tpu/control/trainer.py:663-671), and falling costs never
    plateau."""
    rng = np.random.default_rng(0)
    costs = (50.0 - 0.2 * np.arange(60) + 0.05 * rng.standard_normal(60)).astype(np.float32)
    opt, mon = _monitor(num_min_diff_cost=200)
    f32 = np.float32
    es1 = es2 = dcr = f32(0.0)
    prev = costs[0]
    for step, c in enumerate(costs[1:]):
        dc = c - prev
        es2 = 0.99 * (es2 + (1 - 0.99) * (dc - es1) ** 2)
        es1 = 0.99 * es1 + (1 - 0.99) * dc
        dcr = 0.99 * dcr + (1 - 0.99) * (es1 / np.sqrt(es2 + np.finfo(f32).tiny))
        mon, reduce_lr, exit_now = _update(opt, mon, step, dc)
        assert (reduce_lr, exit_now) == (False, False)
        got = [float(mon.es1[0]), float(mon.es2[0]), float(mon.dcr[0])]
        assert {type(v) for v in (es1, es2, dcr)} == {f32}
        np.testing.assert_allclose(got, [es1, es2, dcr], rtol=1e-12)
        prev = c
    assert mon.dcr[0] < -0.08 and int(mon.consec[0]) == 0 and float(mon.lr[0]) == f32(0.01)
