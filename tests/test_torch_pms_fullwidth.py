"""The 4PMS cart-pole at its full width, the port against the JAX package on
the same inputs: the modules that only 4PMS runs (the sensor chain inside
the rollout, the BPTT clip on its three carried tensors, the exact SE GP at
M=448, the PMS plant and the farm's offline estimator) and the optimizer's
plateau schedule under them.

The dataset is the JAX package's: its 4PMS plant on the CPU runs 5 trials
of ``CartpolePMSConfig()`` (the sum-of-sinusoids exploration, then 4
policies of the scenario's random init), its offline estimator makes the
GP data (N=440, padded to M=448), and its GP is fitted for 1501 epochs;
``utils/convert`` carries the fit across.  Both packages then run at the
scenario's width (P=400, horizon 90, 200 basis functions, ``bptt_clip``
0.2) on the same draws (``jax_rollout_noise``).

The clip's binding share is read by wrapping each package's ``_clip_bptt``
at run time: the package's own clip runs, and an identity after it records
the cotangent the clip receives (every particle's norm, per step, for the
state, the raw measurement and the filtered velocity); the port's side is
``mcpilco_tpu_torch.utils.clip_probe``.

Tolerances, and why:
- rollout cost: rtol 1e-4; gradient: each leaf within 1e-3 of its largest
  entry (float32 BPTT through 90 closed-loop steps of two frameworks);
- cotangent norms: within 2e-2 of the tensor's largest norm; the binding
  share per step and tensor: equal up to the particles whose norm lies
  within 1% of the cap (a norm at the cap may round either way);
- the PMS plant at L=8 and 90 steps: the JAX draws handed to the port;
  positions within 1e-3, velocities (gain 1/dt on position rounding)
  within 3e-2, the offline estimates of the same noisy trajectories within
  1e-5 / 1e-4 (float32 filtfilt, central difference x 15);
- the optimizer in float64 at the scenario's settings: the cost histories
  part by more than 1e-3 relative no earlier than step 300 (338-374 when
  last run); up to that step both loops take the same schedule, and the
  port's monitor (``PolicyOptimizer.replay_schedule``) run over the JAX
  loop's whole history from its probe cost takes the JAX loop's schedule
  exactly: every lr change, dropout change (at 676 and 877) and the stop
  step; within 1000 steps both packages reduce lr and dropout.  Tier-1
  holds the same at a small size with a monitor that fires within 14
  steps: two reductions and the stop, the histories equal to 1e-6.

The cases at P=400 take minutes to hours on the CPU and are marked
``slow``; tier-1 runs a reduced width (P=4, horizon 30) at which the 0.2
cap binds, the farm's data path, and both loops in float64 at a small
size.  ``python tests/test_torch_pms_fullwidth.py ab ...`` runs one key
of the same-dataset A/B of one trial's optimization (see :func:`ab_key`),
``... schedule ...`` one package's side of the full-width float64 loop,
``... stats`` the statistics of the committed rows of both
(``results/torch/pms_ab_*``, ``results/torch/pms_f64_schedule_*``).
"""

import argparse
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# run as a script (the A/B), the tests' directory and the repo root
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from _torch_parity import jax_rollout_noise  # noqa: E402
from mcpilco_tpu.control import rollout as jroll  # noqa: E402
from mcpilco_tpu.control.mc_pilco import ModelFitOptions  # noqa: E402
from mcpilco_tpu.envs import plants as jplants  # noqa: E402
from mcpilco_tpu.scenarios import cartpole_pms as jpms  # noqa: E402
from mcpilco_tpu.utils import prng as jprng  # noqa: E402
from mcpilco_tpu_torch.control import rollout as troll  # noqa: E402
from mcpilco_tpu_torch.control import trainer as ttrainer  # noqa: E402
from mcpilco_tpu_torch.envs import plants as tplants  # noqa: E402
from mcpilco_tpu_torch.models import gp as tgp  # noqa: E402
from mcpilco_tpu_torch.scenarios import cartpole_pms as tpms  # noqa: E402
from mcpilco_tpu_torch.utils import prng as tprng  # noqa: E402
from mcpilco_tpu_torch.utils.clip_probe import ClipShares, clip_cotangents  # noqa: E402
from mcpilco_tpu_torch.utils.convert import to_torch  # noqa: E402

CAP = 0.2
TENSORS = ("state", "raw measurement", "filtered velocity")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "pms_fullwidth_dataset.npz")
RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results",
                       "torch")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ the pieces


def jax_agent(num_trials=5, epochs=1501, num_basis=200, seed=1):
    """The JAX 4PMS agent with its dataset and fitted GP: the exploration
    trial, then ``num_trials - 1`` trials of the scenario's random policy
    init (keys 101, 102, ...), on its own plant on the CPU."""
    cfg = jpms.CartpolePMSConfig(seed=seed, num_basis=num_basis)
    agent, _ = jpms.build(cfg)
    agent.collect(cfg.T_exploration, 0, exploration=True)
    for i in range(1, num_trials):
        agent.policy_params = jpms.policy_init(cfg, agent.policy, jprng.root_key(100 + i))
        agent.collect(cfg.T_control, i, exploration=False)
    agent.fit_model(ModelFitOptions(num_epochs=epochs))
    return agent


def port_agent(num_basis=200, P=400, horizon=90):
    """The port's 4PMS agent on the CPU, optimizer cut to P particles and
    ``horizon`` steps; the scenario's settings otherwise."""
    agent, _ = tpms.build(tpms.CartpolePMSConfig(num_basis=num_basis), "cpu")
    agent.optimizer = dataclasses.replace(agent.optimizer, num_particles=P, horizon=horizon)
    return agent


def carried(jagent, dtype=None):
    """The JAX fit in the port's types (``utils/convert``)."""
    return (to_torch(_np(jagent.gp_params), "cpu", dtype, into=tgp.GPParams),
            to_torch(_np(jagent.posterior), "cpu", dtype, into=tgp.Posterior))


@pytest.fixture(scope="module")
def reduced():
    """A reduced dataset and fit: 2 trials (N=176), 300 epochs, for 20
    basis functions."""
    return jax_agent(num_trials=2, epochs=300, num_basis=20)


@pytest.fixture(scope="module")
def full():
    """The full-width dataset and fit (N=440, M=448)."""
    jagent = jax_agent()
    assert jagent.gp_x.shape == (440, 6) and jagent.posterior.x_tr.shape == (448, 6)
    return jagent


# ------------------------------------------------------------------ clip spies


@contextlib.contextmanager
def jax_clip_cotangents(sink):
    """``jroll._clip_bptt`` wrapped while open: the package's clip, then an
    identity whose backward hands the cotangent that reaches the clip, as
    per-particle norms, to ``sink(tag, norms)``.  The scan traces its step
    once, so the three calls of a step are the three carried tensors
    (``tag`` 0, 1, 2) in order; a backward visits the steps last to first."""
    orig, calls = jroll._clip_bptt, itertools.count()

    @functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
    def seen(x, tag):
        return x

    def bwd(tag, _, g):
        n = jnp.sqrt(jnp.sum(g * g, axis=-1))
        jax.debug.callback(lambda v: sink(tag, np.array(v)), n)
        return (g,)

    seen.defvjp(lambda x, tag: (x, None), bwd)
    jroll._clip_bptt = lambda x, cap: seen(orig(x, cap), next(calls) % 3)
    try:
        yield
    finally:
        jroll._clip_bptt = orig


class Norms:
    """Keeps every norm: ``jax`` is the sink of :func:`jax_clip_cotangents`,
    ``port(T)`` that of ``clip_cotangents`` for rollouts of T steps (a
    call's step is its index // 3 mod T-1, plus 1).  ``array(T)`` gives [3,
    rollouts, T-1, P], steps 1..T-1, zeros where the port ran no backward
    (a tensor that no gradient reaches: the first step's state, from the
    fixed particles, and the last step's raw measurement, which only the
    unused last action reads; the JAX backward computes zeros there)."""

    def __init__(self):
        self.records = []

    def jax(self, tag, norms):
        self.records.append((tag, None, norms.copy()))

    def port(self, T):
        return lambda i, n: self.records.append((i % 3, i // 3 % (T - 1) + 1,
                                                 n.detach().cpu().numpy()))

    def array(self, T):
        out, seen = {}, {}
        for tag, t, v in self.records:
            if t is None:  # the JAX backward: steps T-1 .. 1, rollout after rollout
                i = seen.get(tag, 0)
                seen[tag] = i + 1
                r, t = divmod(i, T - 1)
                t = T - 1 - t
            else:
                r = seen.get((tag, t), 0)
                seen[(tag, t)] = r + 1
            out[tag, r, t] = v
        n = 1 + max(r for _, r, _ in out)
        arr = np.zeros((3, n, T - 1) + next(iter(out.values())).shape, np.float32)
        for (tag, r, t), v in out.items():
            arr[tag, r, t - 1] = v
        return arr


def binding_share(norms):
    """Per tensor and step, the share of particles whose cotangent the cap
    cuts: [3, ..., T-2] from norms [3, ..., T-1, P], steps 2..T-1 (the
    first step's cotangents reach no parameter: the port runs no backward
    there, the JAX package discards it)."""
    return (norms[..., 1:, :] > CAP).mean(axis=-1)


def assert_shares_agree(nj, nt):
    """The binding shares of two packages' norms [3, n, T-1, P] agree step
    by step, up to the particles whose norm lies within 1% of the cap in
    either package; the norms agree within 2e-2 of the tensor's largest
    over the rollout."""
    nj, nt = nj[:, :, 1:], nt[:, :, 1:]  # see binding_share
    near = (np.abs(nj - CAP) < 0.01 * CAP) | (np.abs(nt - CAP) < 0.01 * CAP)
    diff = np.abs((nj > CAP).astype(int) - (nt > CAP).astype(int))
    assert np.all(diff <= near), [TENSORS[i] for i in range(3) if np.any(diff[i] > near[i])]
    scale = np.maximum(np.abs(nj).max(axis=(-2, -1), keepdims=True), 1e-12)
    np.testing.assert_array_less(np.abs(nj - nt) / scale, 2e-2)


# ------------------------------------------------------------------ rollout


def rollout_pair(jagent, tagent, pol, P, T, key, p_drop, s0):
    """Cost, gradient and clip norms of one rollout in both packages on the
    same draws: ((cost, grads, norms) JAX, (...) port)."""
    jeng, teng = jagent.optimizer.engine, tagent.optimizer.engine
    jnorms, tnorms = Norms(), Norms()
    gp, post = jagent.gp_params, jagent.posterior

    def cost_j(pp):
        res = jeng.simulate(key, pp, gp, post, jnp.asarray(s0), T, p_dropout=p_drop)
        return jagent.cost(res.states, res.inputs)[0]

    with jax_clip_cotangents(jnorms.jax):
        cj, gj = jax.jit(jax.value_and_grad(cost_j))(pol)
    tg, tp = carried(jagent)
    noise = jax_rollout_noise(key, P, T, 2, tagent.policy.num_basis, p_drop, n_pos=2)
    leaves = {k: v.clone().requires_grad_(True) for k, v in to_torch(_np(pol), "cpu").items()}
    with clip_cotangents(tnorms.port(T)):
        res = teng.simulate(None, leaves, tg, tp, torch.as_tensor(s0), T, p_dropout=p_drop,
                            noise=noise)
        ct, _ = tagent.cost(res.states, res.inputs)
        gt = torch.autograd.grad(ct, list(leaves.values()))
    return ((float(cj), {k: np.asarray(v) for k, v in gj.items()}, jnorms.array(T)),
            (ct.item(), {k: g.numpy() for k, g in zip(leaves, gt)}, tnorms.array(T)))


def assert_rollouts_agree(j, t):
    (cj, gj, nj), (ct, gt, nt) = j, t
    np.testing.assert_allclose(ct, cj, rtol=1e-4)
    for name, g in gt.items():
        scale = float(np.abs(gj[name]).max())
        np.testing.assert_allclose(g, gj[name], rtol=0, atol=1e-3 * scale, err_msg=name)
    assert_shares_agree(nj, nt)


def test_pms_reduced_width_clip_binds_and_matches_jax(reduced):
    """Tier-1: 2 trials (N=176), P=4 particles, horizon 30, 20 basis
    functions.  At 4 particles each particle's share of the cost is 100x
    its share at 400, and the cap of 0.2 binds on the state and the raw
    measurement; the filtered velocity's cotangent is ~1e-19 (butter(1,
    0.5) has a1 = 0 up to rounding, so the filter does not feed back)."""
    jagent = reduced
    tagent = port_agent(num_basis=20, P=4, horizon=30)
    pol = jpms.policy_init(jpms.CartpolePMSConfig(num_basis=20), jagent.policy,
                           jprng.root_key(7))
    s0 = (1e-2 * np.random.default_rng(0).standard_normal((4, 4))).astype(np.float32)
    j, t = rollout_pair(jagent, tagent, pol, 4, 30, jax.random.PRNGKey(3), 0.25, s0)
    assert_rollouts_agree(j, t)
    share_j, share_t = binding_share(j[2]), binding_share(t[2])
    print("binding share JAX / port:", share_j.mean(axis=(1, 2)), share_t.mean(axis=(1, 2)))
    for i in (0, 1):
        assert share_j[i].max() > 0 and share_t[i].max() > 0, TENSORS[i]
    assert np.abs(j[2][2]).max() < 1e-12 and np.abs(t[2][2]).max() < 1e-12


@pytest.mark.slow
def test_pms_full_width_rollout_matches_jax(full):
    """P=400, horizon 90, 200 basis, M=448: cost, gradient and the clip's
    binding share per step and tensor, at two policies of the scenario's
    init."""
    tagent = port_agent()
    cfg = jpms.CartpolePMSConfig()
    s0 = (1e-2 * np.random.default_rng(0).standard_normal((400, 4))).astype(np.float32)
    for seed in (7, 8):
        pol = jpms.policy_init(cfg, full.policy, jprng.root_key(seed))
        j, t = rollout_pair(full, tagent, pol, 400, 90, jax.random.PRNGKey(seed), 0.25, s0)
        assert_rollouts_agree(j, t)


# ------------------------------------------------------------------ the farm's data path


def farm_data_pair(L=8, T=3.0):
    """The farm's data path of L lanes, each with its own policy of the
    scenario's init: JAX (``_device_rollout`` and
    ``offline_velocity_estimation_jax``, vmapped over the lanes as the JAX
    farm's ``one``) and the port (``rollout_lanes``, then
    ``offline_velocity_estimation_lanes``), the JAX measurement draws
    handed to the port.  Returns (JAX (true, noisy, est, inputs), port
    (true, noisy, est, inputs), the port's estimates of the JAX noisy
    trajectories)."""
    cfg = jpms.CartpolePMSConfig()
    jagent, _ = jpms.build(cfg)
    tagent, _ = tpms.build(tpms.CartpolePMSConfig(), "cpu")
    dt, n = cfg.dt, int(round(T / cfg.dt))
    keys = jnp.stack([jprng.fold(jprng.stream(jprng.root_key(s), jprng.STREAM_SYSTEM), 1)
                      for s in range(1, L + 1)])
    params = [jpms.policy_init(cfg, jagent.policy, jprng.root_key(s)) for s in range(1, L + 1)]
    params_b = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *params)
    x0 = np.zeros(4, np.float32)
    pos, vel = jagent.model.pos_indices, jagent.model.vel_indices

    def one(key, p):
        measured, inputs, states, noisy = jagent.plant._device_rollout(jagent.policy, p)(
            key, jnp.asarray(x0), 0.0, n, dt)
        est, inputs_t = jplants.offline_velocity_estimation_jax(noisy, inputs, dt, pos, vel)
        return states, noisy, est, inputs_t

    jout = [np.asarray(a) for a in jax.jit(jax.vmap(one))(keys, params_b)]
    eps = torch.as_tensor(np.stack([np.stack([
        np.asarray(jax.random.normal(jprng.fold(jprng.stream(k, jprng.STREAM_MEAS_NOISE), i + 1),
                                     (4,))) for i in range(n)]) for k in keys]))
    # the port's lane keys only seed its exploration stream, which this
    # feedback policy does not read
    tkeys = [tprng.fold(tprng.stream(tprng.root_key(s), tprng.STREAM_SYSTEM), 1)
             for s in range(1, L + 1)]
    tparams = {k: torch.stack([to_torch(_np(p), "cpu")[k] for p in params]) for k in params[0]}
    trial = tagent.plant.rollout_lanes(tkeys, np.zeros((L, 4)), tagent.policy, tparams, T, dt,
                                       device="cpu", eps=eps)
    est, inputs = tplants.offline_velocity_estimation_lanes(
        torch.as_tensor(trial.noisy), torch.as_tensor(trial.inputs), dt, pos, vel)
    on_jax_noisy, _ = tplants.offline_velocity_estimation_lanes(
        torch.as_tensor(jout[1].copy()), torch.as_tensor(trial.inputs), dt, pos, vel)
    return (jout, (trial.true, trial.noisy, est.numpy(), inputs.numpy()), on_jax_noisy.numpy())


def test_pms_farm_data_path_at_eight_lanes_matches_jax():
    """The PMS plant at L=8 over the scenario's 90 steps, then the offline
    estimator, as the JAX farm's vmapped ``one``."""
    (jtrue, jnoisy, jest, jin), (ttrue, tnoisy, test_, tin), on_jax = farm_data_pair()
    assert ttrue.shape == jtrue.shape == (8, 91, 4) and test_.shape == jest.shape == (8, 89, 4)
    for got, want in ((ttrue, jtrue), (tnoisy, jnoisy), (test_, jest)):
        np.testing.assert_allclose(got[..., [0, 2]], want[..., [0, 2]], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[..., [1, 3]], want[..., [1, 3]], rtol=0, atol=3e-2)
    np.testing.assert_allclose(tin, jin, rtol=0, atol=1e-3)
    np.testing.assert_allclose(on_jax[..., [0, 2]], jest[..., [0, 2]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(on_jax[..., [1, 3]], jest[..., [1, 3]], rtol=0, atol=1e-4)
    # the lanes ran different policies
    assert np.ptp(jtrue[:, -1, 2]) > 0.1


# ------------------------------------------------------------------ the optimizer


# the loop state of the JAX optimizer that it keeps in float32
_F32_CARRY = ("lr", "p_drop", "thr", "gate_step", "es1", "es2", "dcr", "best_cost", "lr0",
              "p_dropout0")


def jax_optimize(opt, pol, key, num_steps, gp, post, f64=False):
    """The JAX optimizer driven one step per call of its compiled chunk
    (the loop's own ``_optimize_init`` / ``_optimize_chunk``), which lets
    the host read the schedule after every step.  ``f64``: the loop state
    that the JAX loop keeps in float32 starts in float64, so that a float64
    rollout's cost flows through it (``opt`` then needs
    ``nan_branch_style="off"``: the NaN branches re-initialize that state in
    float32).  Returns (the final carry, [(step, lr, p_drop, done)] after
    each step, the probe cost: the monitor's first ``cost_prev``)."""
    carry = opt._optimize_init(key, pol, gp, post, 0.01, 0.25, 0, jnp.zeros((), jnp.int32))
    cost0 = float(carry.cost_prev)
    if f64:
        carry = carry._replace(**{f: getattr(carry, f).astype(jnp.float64) for f in _F32_CARRY})
    sched = []
    for s in range(num_steps):
        carry = opt._optimize_chunk(carry, key, gp, post, jnp.int32(s + 1),
                                    carry.iters + 64, 0)
        sched.append((int(carry.step), float(carry.lr), float(carry.p_drop), bool(carry.done)))
        if sched[-1][3]:
            break
    return carry, sched, cost0


def port_schedule_spy(patch):
    """``PolicyOptimizer.monitor_update`` wrapped (``patch``: a setattr,
    ``monkeypatch.setattr`` in tests): [(step + 1, lr, p_drop, exit)] of
    every iteration, as :func:`jax_optimize` reads them."""
    sched = []
    orig = ttrainer.PolicyOptimizer.monitor_update

    def spy(self, mon, step, dc):
        new, reduce_lr, exit_now = orig(self, mon, step, dc)
        sched.append((int(step[0]) + 1, float(new.lr[0]), float(new.p_drop[0]),
                      bool(exit_now[0])))
        return new, reduce_lr, exit_now

    patch(ttrainer.PolicyOptimizer, "monitor_update", spy)
    return sched


def _uniforms_f32(u, rates=(0.25, 0.125, 0.0)):
    """float64 dropout uniforms as float32 that keep every decision
    ``u < 1 - rate`` of the schedule's rates (the port's buffer holds
    float32; rounding may lift a uniform just under a threshold onto it)."""
    v = u.astype(np.float32)
    for r in rates:
        th = np.float32(1.0 - r)
        v = np.where((u < th) & (v >= th), np.nextafter(th, np.float32(0)), v)
    return v


def _f64_sampling(patch):
    """Both packages sample the initial particles in float32 by default;
    in float64 from here on, so that the whole rollout runs in float64."""
    for mod, f64 in ((jroll, jnp.float64), (troll, torch.float64)):
        patch(mod.InitialStateDistribution, "sample", functools.partialmethod(
            mod.InitialStateDistribution.sample, dtype=f64))


def f64_jax_side(jagent, pol, key_seed, num_steps, patch):
    """The JAX optimizer of ``jagent`` in float64 from ``pol`` for
    ``num_steps``, ``nan_branch_style="off"`` (see :func:`jax_optimize`;
    equal to the default on a run without NaN).  Returns (cost history,
    schedule, probe cost)."""
    _f64_sampling(patch)
    with jax.enable_x64():
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jopt = dataclasses.replace(jagent.optimizer, nan_branch_style="off")
        carry, sched, cost0 = jax_optimize(jopt, f64(pol), jax.random.PRNGKey(key_seed),
                                           num_steps, f64(jagent.gp_params),
                                           f64(jagent.posterior), f64=True)
    return np.asarray(carry.cost_hist)[:int(carry.step)], sched, cost0


def f64_port_side(jagent, tagent, pol, key_seed, num_steps, patch):
    """The port's optimizer of ``tagent`` in float64 on the JAX fit of
    ``jagent``, handed the JAX loop's draws of every step (``noise_fn``).
    Returns (cost history, schedule)."""
    _f64_sampling(patch)
    P, T, NB = tagent.optimizer.num_particles, tagent.optimizer.horizon, tagent.policy.num_basis
    with jax.enable_x64():
        jkey, tkey = jax.random.PRNGKey(key_seed), tprng.root_key(key_seed)

        def noise_fn(k):
            n = jax_rollout_noise(jprng.fold(jkey, *k[len(tkey):]), P, T, 2, NB, 0.25,
                                  init_dim=4, n_pos=2, dtype=jnp.float64, keep_uniforms=True)
            return n._replace(keep=torch.as_tensor(_uniforms_f32(n.keep.numpy())))

        tsched = port_schedule_spy(patch)
        tg, tp = carried(jagent, torch.float64)
        tpol = to_torch(_np(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), pol)),
                        "cpu")
        res = tagent.optimizer.optimize(tkey, tpol, tg, tp, num_steps, 0.01, 0.25, 0,
                                        noise_fn=noise_fn, graph=False, chunk=1)
    return res.cost_history.numpy()[:res.steps_done], tsched


def parting_step(a, b, rtol=1e-3):
    """The first step at which two cost histories part by more than
    ``rtol`` relative, or None."""
    n = min(len(a), len(b))
    far = np.abs(a[:n] - b[:n]) > rtol * np.abs(a[:n])
    return int(np.argmax(far)) if far.any() else None


def assert_schedules_agree(jside, tside, opt, min_part):
    """The two loops' histories part no earlier than ``min_part``; up to
    that step they take the same schedule; and the port's monitor replayed
    over the whole JAX history from its probe cost takes the JAX schedule
    exactly (every event and the stop step).  Returns (parting step, the
    JAX events, the port's)."""
    (jcosts, jsched, cost0), (tcosts, tsched) = jside, tside
    part = parting_step(jcosts, tcosts)
    upto = min(len(jcosts), len(tcosts)) if part is None else part
    assert upto >= min_part, f"the histories part at step {part}"
    jev, tev = ttrainer.schedule_events(jsched), ttrainer.schedule_events(tsched)
    assert ttrainer.schedule_events(jsched[:upto]) == ttrainer.schedule_events(tsched[:upto])
    assert opt.replay_schedule(jcosts, cost0) == jev
    return part, jev, tev


def test_pms_reduced_width_float64_optimizer_matches_jax(reduced, monkeypatch):
    """Tier-1: both optimization loops in float64 at P=8, horizon 10, 20
    basis, 20 steps on the same draws: the same float32 cost histories
    (the port's loop logs a float64 rollout's cost in its float32 history,
    as the JAX loop does)."""
    jagent = copy.copy(reduced)
    jagent.optimizer = dataclasses.replace(reduced.optimizer, num_particles=8, horizon=10)
    tagent = port_agent(num_basis=20, P=8, horizon=10)
    pol = jpms.policy_init(jpms.CartpolePMSConfig(num_basis=20), reduced.policy,
                           jprng.root_key(7))
    jside = f64_jax_side(jagent, pol, 11, 20, monkeypatch.setattr)
    tside = f64_port_side(jagent, tagent, pol, 11, 20, monkeypatch.setattr)
    jcosts, tcosts = jside[0], tside[0]
    assert len(jcosts) == len(tcosts) == 20 and parting_step(jcosts, tcosts) is None
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-6)
    assert ttrainer.schedule_events(jside[1]) == ttrainer.schedule_events(tside[1])


def test_pms_reduced_width_schedule_events_match_jax(reduced, monkeypatch):
    """Tier-1: the loops of the float64 case above with a monitor that
    fires at once (min_step 4, num_min_diff_cost 3, a threshold that every
    cost change meets): lr and dropout reduced at steps 6 and 10, the stop
    at lr_min at step 14, equal in both packages, with the histories equal
    to 1e-6 across the reductions; the port's monitor replayed over the
    JAX history takes the same schedule."""
    fast = dict(min_step=4.0, num_min_diff_cost=3, min_diff_cost=1e6)
    jagent = copy.copy(reduced)
    jagent.optimizer = dataclasses.replace(reduced.optimizer, num_particles=8, horizon=10,
                                           **fast)
    tagent = port_agent(num_basis=20, P=8, horizon=10)
    tagent.optimizer = dataclasses.replace(tagent.optimizer, **fast)
    pol = jpms.policy_init(jpms.CartpolePMSConfig(num_basis=20), reduced.policy,
                           jprng.root_key(7))
    jside = f64_jax_side(jagent, pol, 11, 40, monkeypatch.setattr)
    tside = f64_port_side(jagent, tagent, pol, 11, 40, monkeypatch.setattr)
    part, jev, tev = assert_schedules_agree(jside, tside, tagent.optimizer, min_part=14)
    assert part is None and jev == tev
    lr = [float(np.float32(v)) for v in (0.005, 0.0025)]
    assert jev == ([(6, lr[0], 0.125), (10, lr[1], 0.0)], 14)
    np.testing.assert_allclose(tside[0], jside[0], rtol=1e-6)


@pytest.mark.slow
def test_pms_full_width_optimizer_schedule_matches_jax(monkeypatch):
    """The scenario's settings (min_step 200, num_min_diff_cost 200, lr_min
    0.0025, p_drop_reduction 0.125) in float64 on the same draws, for 1000
    steps (~1.8 h with 4 threads, ~4.5 h on one core): the histories part no
    earlier than step 300 (353 on one core, 374 on four, when last run),
    the port's monitor replayed over the JAX history takes its schedule
    exactly (lr and dropout reduced at 676 and 877, no stop), and both
    loops reduce lr and dropout (the port's own loop at 675 and 876, past
    the parting step)."""
    jagent, tagent = dataset_agent(), port_agent()
    pol = jpms.policy_init(jpms.CartpolePMSConfig(), jagent.policy, jprng.root_key(7))
    jside = f64_jax_side(jagent, pol, 11, 1000, monkeypatch.setattr)
    tside = f64_port_side(jagent, tagent, pol, 11, 1000, monkeypatch.setattr)
    part, jev, tev = assert_schedules_agree(jside, tside, tagent.optimizer, min_part=300)
    print(f"cost histories part at step {part} of {len(jside[0])}; events JAX {jev}, port {tev}")
    for ev, _ in (jev, tev):  # the lr decay and the dropout reduction fired
        assert [(lr < 0.01, p < 0.25) for _, lr, p in ev][:1] == [(True, True)]


# ------------------------------------------------------------------ the A/B


def save_dataset(jagent, path=FIXTURE):
    """The dataset and the fitted GP hyperparameters of ``jagent`` as an
    npz (``chip_smoke.py`` phase 17 rebuilds the posterior from it in the
    port, without JAX)."""
    leaves = {f"gp_{k}": np.asarray(v) for k, v in jagent.gp_params._asdict().items()
              if not isinstance(v, dict)}
    kern = {f"kernel_{k}": np.asarray(v) for k, v in jagent.gp_params.kernel.items()}
    np.savez_compressed(path, gp_x=jagent.gp_x, gp_y=jagent.gp_y, **leaves, **kern)


def dataset_agent(path=FIXTURE):
    """A JAX 4PMS agent holding the saved dataset and GP hyperparameters,
    its posterior built by the JAX package."""
    agent, _ = jpms.build(jpms.CartpolePMSConfig())
    d = np.load(path)
    agent.gp_x, agent.gp_y = d["gp_x"], d["gp_y"]
    params = agent.gp.init_params()
    kern = {k[len("kernel_"):]: jnp.asarray(d[k]) for k in d.files if k.startswith("kernel_")}
    agent.gp_params = params._replace(
        kernel=kern, **{k[len("gp_"):]: jnp.asarray(d[k]) for k in d.files
                        if k.startswith("gp_") and k not in ("gp_x", "gp_y")})
    agent.posterior = agent._build_posterior(agent._padded_data())
    return agent


@pytest.mark.slow
def test_saved_dataset_is_the_jax_plants(full):
    """The saved dataset is what :func:`jax_agent` makes now: the same
    samples, hyperparameters within 1e-4, and the posterior built from them
    equal to the fit's."""
    saved = dataset_agent()
    np.testing.assert_array_equal(saved.gp_x, full.gp_x)
    np.testing.assert_array_equal(saved.gp_y, full.gp_y)
    for a, b in zip(jax.tree_util.tree_leaves(saved.gp_params),
                    jax.tree_util.tree_leaves(full.gp_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def executed_cost(package, plant, policy, params, cost, seed, T=3.0, dt=1.0 / 30.0):
    """The policy run once on its own package's 4PMS plant from the fixed
    initial state (the key of the seed's trial 1), scored as ``repeat``
    scores a trial: the stage costs of the true states and inputs, trimmed
    to [1:-1] as the offline estimation trims them.  Returns (cost,
    swing-up success)."""
    if package == "jax":
        key = jprng.fold(jprng.stream(jprng.root_key(seed), jprng.STREAM_SYSTEM), 1)
        trial = plant.rollout(key, np.zeros(4, np.float32), policy, params, T, dt)
        true, inputs = np.asarray(trial.true)[1:-1], np.asarray(trial.inputs)[1:-1]
        stage = cost.stage_costs(jnp.asarray(true[:, None]), jnp.asarray(inputs[:, None]), 0)
    else:
        key = tprng.fold(tprng.stream(tprng.root_key(seed), tprng.STREAM_SYSTEM), 1)
        trial = plant.rollout(key, np.zeros(4, np.float32), policy, params, T, dt, device="cpu")
        true, inputs = trial.true[1:-1], trial.inputs[1:-1]
        stage = cost.stage_costs(torch.as_tensor(true[:, None]), torch.as_tensor(inputs[:, None]),
                                 0)
    return float(np.sum(np.asarray(stage))), bool(tpms.swingup_success(true))


def ab_key(package, seed, num_steps, jagent):
    """One key of the A/B: the scenario's trial-0 optimization (lr 0.01,
    dropout 0.25, the scenario's monitor) from the policy init of ``seed``
    with the package's own PRNG, on the dataset of ``jagent`` (the JAX
    posterior, carried across for the port), for at most ``num_steps``.
    Returns the statistics of the key: the in-model cost of the returned
    policy (its best), the last cost, the executed cost and success, the
    clip's binding share per carried tensor over the run, the stop step,
    the schedule's events and seconds; for JAX, whether the port's monitor
    replayed over the JAX history takes the same schedule."""
    t0 = time.time()
    shares = ClipShares(CAP)
    cfg = jpms.CartpolePMSConfig()
    if package == "jax":
        jax.clear_caches()  # a compiled loop of an earlier key holds its recorder
        key = jprng.fold(jprng.stream(jprng.root_key(seed), jprng.STREAM_ROLLOUT), 0)
        pol = jpms.policy_init(cfg, jagent.policy, jprng.root_key(seed))
        with jax_clip_cotangents(shares):
            carry, sched, cost0 = jax_optimize(jagent.optimizer, pol, key, num_steps,
                                               jagent.gp_params, jagent.posterior)
        steps = int(carry.step)
        costs = np.asarray(carry.cost_hist)[:steps]
        params = jax.tree_util.tree_map(
            lambda b, l: jnp.where(jnp.isfinite(carry.best_cost), b, l), carry.best_params,
            carry.params)
        executed, success = executed_cost("jax", jagent.plant, jagent.policy, params,
                                          jagent.cost, seed)
        monitor_agrees = (port_agent().optimizer.replay_schedule(costs, cost0)
                          == ttrainer.schedule_events(sched))
    else:
        tagent = port_agent()
        orig = ttrainer.PolicyOptimizer.monitor_update
        try:
            sched = port_schedule_spy(setattr)
            tg, tp = carried(jagent)
            key = tprng.fold(tprng.stream(tprng.root_key(seed), tprng.STREAM_ROLLOUT), 0)
            pol = tpms.policy_init(cfg, tagent.policy, tprng.root_key(seed), "cpu")
            with clip_cotangents(shares):
                res = tagent.optimizer.optimize(key, pol, tg, tp, num_steps, 0.01, 0.25, 0,
                                                graph=False)
        finally:
            ttrainer.PolicyOptimizer.monitor_update = orig
        steps, costs = res.steps_done, res.cost_history.numpy()[:res.steps_done]
        executed, success = executed_cost("port", tagent.plant, tagent.policy,
                                          res.policy_params, tagent.cost, seed)
        monitor_agrees = None
    ev, stop = ttrainer.schedule_events(sched)
    return dict(package=package, seed=seed, cap=num_steps, steps=steps,
                best_cost=float(np.min(costs)), last_cost=float(costs[-1]),
                executed_cost=executed, success=success, clip_share=shares.shares()[0].tolist(),
                stop_step=stop, events=ev, monitor_agrees=monitor_agrees,
                seconds=time.time() - t0)


def schedule_side(package, steps, threads):
    """One package's side of the full-width float64 loop of
    :func:`test_pms_full_width_optimizer_schedule_matches_jax`, as a row:
    its cost history, schedule and events (and for JAX the probe cost)."""
    t0 = time.time()
    torch.set_num_threads(threads)
    jagent = dataset_agent()
    pol = jpms.policy_init(jpms.CartpolePMSConfig(), jagent.policy, jprng.root_key(7))
    if package == "jax":
        costs, sched, cost0 = f64_jax_side(jagent, pol, 11, steps, setattr)
    else:
        (costs, sched), cost0 = f64_port_side(jagent, port_agent(), pol, 11, steps, setattr), None
    ev, stop = ttrainer.schedule_events(sched)
    return dict(package=package, steps=steps, threads=threads, costs=costs.tolist(),
                sched=sched, events=ev, stop_step=stop, cost0=cost0, seconds=time.time() - t0)


def _quartiles(v):
    return "median {:.4f} (q25 {:.4f}, q75 {:.4f})".format(*np.percentile(v, [50, 25, 75]))


def stats(results=RESULTS, reps=20000):
    """The statistics of the committed rows: the CPU A/B per package and
    against each other (Mann-Whitney p), the card's rows (phase 17) at the
    CPU's cap, the power of the CPU A/B's test against C.3's effect (the
    4PMS sweeps' successes, port against the JAX record: a relative shift
    of the median cost), and the full-width float64 loop."""
    from scipy.stats import mannwhitneyu

    rows = {p: sorted((json.loads(line) for line in
                       open(os.path.join(results, f"pms_ab_cpu_{p}.jsonl"))),
                      key=lambda r: r["seed"]) for p in ("jax", "port")}
    with open(os.path.join(results, "pms_ab_h100.json")) as f:
        card = json.load(f)["pms_ab"]
    cap = rows["jax"][0]["cap"]
    rows["card"] = card[str(cap)]["rows"]
    col = lambda p, k: np.asarray([r[k] for r in rows[p]], np.float64)
    for p, r in rows.items():
        print(f"{p}: {len(r)} keys (seeds {[x['seed'] for x in r]}), cap {cap}")
        for k in ("best_cost", "last_cost", "executed_cost"):
            print(f"  {k}: {_quartiles(col(p, k))}")
        share = np.asarray([x["clip_share"] for x in r])
        print(f"  clip share (state, raw, filtered velocity): mean {share.mean(0).tolist()}, "
              f"state {share[:, 0].min()}-{share[:, 0].max()}")
        print(f"  swing-ups {sum(x['success'] for x in r)}, stop steps "
              f"{[x['stop_step'] for x in r]}, first event "
              f"{[x['events'][0][0] if x['events'] else None for x in r]}")
    print(f"  the port's monitor takes each JAX key's schedule: "
          f"{[x['monitor_agrees'] for x in rows['jax']]}")
    for a, b in (("jax", "port"), ("jax", "card"), ("port", "card")):
        ps = {k: mannwhitneyu(col(a, k), col(b, k)).pvalue
              for k in ("best_cost", "executed_cost")}
        ps["clip share (state)"] = mannwhitneyu([x["clip_share"][0] for x in rows[a]],
                                                [x["clip_share"][0] for x in rows[b]]).pvalue
        first = [[x["events"][0][0] for x in rows[p] if x["events"]] for p in (a, b)]
        ps["first event"] = mannwhitneyu(*first).pvalue
        print(f"{a} vs {b}: Mann-Whitney p " + ", ".join(f"{k} {float(v):.4f}"
                                                         for k, v in ps.items()))
    sweeps = [os.path.join(results, "repeat_cartpole_pms_h100.json"),
              os.path.join(results, "..", "repeat_pms5_50seeds_r3.json")]
    med = []
    for path in sweeps:
        with open(path) as f:
            s = json.load(f)
        med.append(np.median([c for k, c in s["per_seed_cost"].items() if s["per_seed"][k]]))
    shift = 1.0 - med[0] / med[1]
    rng = np.random.default_rng(0)
    for k in ("best_cost", "executed_cost"):
        pool = np.concatenate([col("jax", k), col("port", k)])
        n = len(rows["jax"])
        hits = sum(mannwhitneyu(rng.choice(pool, n), rng.choice(pool, n) * (1 - shift)).pvalue
                   < 0.05 for _ in range(reps))
        print(f"power of the A/B's {k} test (n = {n} per package, p < 0.05) against C.3's "
              f"shift of {shift:.4f} (successes' median {med[0]:.4f} port, {med[1]:.4f} JAX): "
              f"{hits / reps:.4f} ({reps} resamples of the pooled keys)")
    sides = {}
    for p in ("jax", "port"):
        with open(os.path.join(results, f"pms_f64_schedule_cpu_{p}.json")) as f:
            sides[p] = json.load(f)
    jside = (np.asarray(sides["jax"]["costs"], np.float32), sides["jax"]["sched"],
             sides["jax"]["cost0"])
    tside = (np.asarray(sides["port"]["costs"], np.float32), sides["port"]["sched"])
    part, jev, tev = assert_schedules_agree(jside, tside, port_agent().optimizer, 300)
    print(f"float64 loop at full width ({sides['jax']['threads']} / "
          f"{sides['port']['threads']} threads): the histories part at step {part}; "
          f"identical to step {parting_step(jside[0], tside[0], rtol=0.0)}; events JAX {jev}, "
          f"port {tev}; the port's monitor replayed over the JAX history takes JAX's")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("dataset", help="make and save the full-width dataset")
    s.add_argument("--out", default=FIXTURE)
    a = sub.add_parser("ab", help="one package's side of the A/B, key by key")
    a.add_argument("--package", choices=("jax", "port"), required=True)
    a.add_argument("--seeds", default="1")
    a.add_argument("--steps", type=int, default=2000)
    a.add_argument("--threads", type=int, default=1)
    a.add_argument("--out", required=True)
    f = sub.add_parser("schedule", help="one package's side of the full-width float64 loop")
    f.add_argument("--package", choices=("jax", "port"), required=True)
    f.add_argument("--steps", type=int, default=1000)
    f.add_argument("--threads", type=int, default=4)
    f.add_argument("--out", required=True)
    sub.add_parser("stats", help="the statistics of the committed A/B and float64 rows")
    args = p.parse_args(argv)
    if args.cmd == "dataset":
        save_dataset(jax_agent(), args.out)
    elif args.cmd == "stats":
        stats()
    elif args.cmd == "schedule":
        with open(args.out, "w") as out:
            json.dump(schedule_side(args.package, args.steps, args.threads), out)
    else:
        torch.set_num_threads(args.threads)
        jagent = dataset_agent()
        for seed in (int(x) for x in args.seeds.split(",")):
            row = ab_key(args.package, seed, args.steps, jagent)
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as out:
                out.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
