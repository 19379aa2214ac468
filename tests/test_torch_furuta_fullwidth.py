"""Furuta at its full width, the port against the JAX package on the same
inputs: the semiparametric GP's fit (Sum(SEArd, Linear) with output
normalization, 1501 epochs, the backtracking NaN guard, the posterior's
jitter escalation), the closed-loop rollout with the delta cap (P=400,
horizon 150, 200 basis functions), the optimizer's plateau schedule at
Furuta's slow-exit monitor settings, and the optimizer's NaN guard.

The dataset is the JAX package's: its Furuta plant on the CPU runs the
exploration trial and then 3 trials of the scenario's random policy init
(keys 101-103) of ``FurutaConfig()``.  Two stages of it are used: trial 0's
data (the exploration trial, N=150), where the delta cap binds most, and
all four trials (N=600).  The fixture also holds the JAX package's float32
fit of the second stage (1501 epochs), which ``utils/convert`` carries
across.

The cap's binding is read at run time after each package's own cap: the
JAX side wraps ``RolloutEngine._cap_delta`` (the package's cap, then a
``jax.debug.callback`` of what it changed), the port's side is
``mcpilco_tpu_torch.utils.cap_probe``.

Tolerances, and why:
- the fit in float64: the loss history within 1e-9 relative and the final
  hyperparameters within 1e-8 (1501 Adam steps of two frameworks' float64
  MLL gradients); in float32 both packages revert the same number of
  epochs (0 when last run) and keep the posterior at the same jitter scale
  (1);
- the rollout in float32: cost rtol 1e-4, the gradient of each leaf within
  1e-3 of its largest entry (of the particles whose two trajectories never
  part, below); the cap's binding per step, head and particle
  equal up to the particles whose raw mean or variance lies within 1% of
  the cap (a value at the cap may round either way), and up to the
  particle-steps after a particle's two trajectories part (an angle by
  1e-2 rad, a velocity by 1e-2 relative: off the data the capped rollout
  expands a difference ~10x in 10 steps, in float64 too: a particle that
  starts far off the data parts near step 90 in float32 and near step 110
  in float64) or its two predictions part by 1% of the cap;
- the optimizer in float64 at the scenario's settings (alpha 0.99,
  min_diff_cost 0.04, num_min_diff_cost 400, min_step 400, lr_min 0.001,
  p_drop_reduction 0.125): its first rollout (the loop's own initial
  particles and draws) gives the same cost to 1e-12 and the same gradient
  to 1e-9 of each leaf's largest entry (4e-11 when last run); from there
  Furuta's closed loop magnifies that rounding ~10x a step, so the cost
  histories part by more than 1e-3 relative no earlier than step 8
  (``F64_MIN_PART``; identical in float32 to step 6, parting at step 10
  when last run), and the port's monitor (``PolicyOptimizer.
  replay_schedule``) run over the JAX loop's whole 1000-step history takes
  the JAX loop's schedule exactly.  Tier-1 holds the same at a small size
  with a monitor that fires within a few dozen steps, the histories equal
  to 1e-6;
- the NaN guard on a forced NaN rollout (the JAX draws handed to the port,
  the NaN forced on the same keys in both): the same re-samples, re-inits,
  iterations and steps, the same leaves and monitor fields reset to the
  same values, and the cost histories within 1e-5 up to the re-init (whose
  fresh policy each package draws from its own generator).

The cases at P=400 take minutes to an hour on the CPU and are marked
``slow``.  ``python tests/test_torch_furuta_fullwidth.py dataset`` remakes
the fixture (~2 min); ``... guard`` prints both fits' guard and jitter
records; ``... schedule --package jax|port --out side.json`` runs one
side of the full-width float64 loop (both sides at once, one process each,
is how it was last run, 3 threads each: ``results/torch/furuta_f64_schedule_cpu_*.json``),
and ``... compare jax.json port.json`` holds the two sides as the slow test
does.  The farm against ``MCPilco.reinforce`` over whole Furuta trials is
``tests/test_torch_farm_scenarios.py``'s.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# run as a script (the dataset), the tests' directory and the repo root
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from _torch_parity import jax_rollout_noise  # noqa: E402
from test_torch_pms_fullwidth import (_uniforms_f32, assert_schedules_agree,  # noqa: E402
                                      f64_jax_side, jax_optimize, parting_step,
                                      port_schedule_spy)
from mcpilco_tpu.control import rollout as jroll  # noqa: E402
from mcpilco_tpu.control.mc_pilco import ModelFitOptions  # noqa: E402
from mcpilco_tpu.scenarios import furuta as jfur  # noqa: E402
from mcpilco_tpu.utils import prng as jprng  # noqa: E402
from mcpilco_tpu_torch.control import rollout as troll  # noqa: E402
from mcpilco_tpu_torch.control import trainer as ttrainer  # noqa: E402
from mcpilco_tpu_torch.models import gp as tgp  # noqa: E402
from mcpilco_tpu_torch.scenarios import furuta as tfur  # noqa: E402
from mcpilco_tpu_torch.utils import prng as tprng  # noqa: E402
from mcpilco_tpu_torch.utils.cap_probe import delta_cap_binding  # noqa: E402
from mcpilco_tpu_torch.utils.convert import to_torch  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "furuta_fullwidth_dataset.npz")
# the dataset's stages: trial 0's data, and all four trials'
STAGES = {"trial 0": 150, "four trials": 600}
G = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ the dataset


def jax_dataset_agent(num_trials=4):
    """The JAX Furuta agent after the exploration trial and ``num_trials -
    1`` trials of the scenario's random policy init (keys 101, 102, ...),
    on its own plant on the CPU; no fit."""
    cfg = jfur.FurutaConfig()
    agent, _ = jfur.build(cfg)
    agent.collect(cfg.T_exploration, 0, exploration=True)
    for i in range(1, num_trials):
        agent.policy_params = jfur.policy_init(cfg, agent.policy, jprng.root_key(100 + i))
        agent.collect(cfg.T_control, i, exploration=False)
    return agent


def _gp_template(jagent):
    return jagent.gp.init_params(sigma_n=jagent.gp_sigma_n_init,
                                 per_head_overrides=jagent.gp_init_overrides)


def save_dataset(path=FIXTURE):
    """The dataset and the JAX package's float32 fit of all four trials
    (1501 epochs), its leaves in ``jax.tree_util`` order."""
    jagent = jax_dataset_agent()
    jagent.fit_model(ModelFitOptions(num_epochs=1501))
    leaves = jax.tree_util.tree_leaves(jagent.gp_params)
    np.savez_compressed(path, gp_x=jagent.gp_x, gp_y=jagent.gp_y,
                        **{f"fit_{i}": np.asarray(v) for i, v in enumerate(leaves)})


def dataset_agent(stage="four trials", fitted=True):
    """A JAX Furuta agent holding the saved dataset up to ``stage`` and, if
    ``fitted``, the saved hyperparameters with the posterior the JAX package
    builds from them on that data."""
    jagent, _ = jfur.build(jfur.FurutaConfig())
    d = np.load(FIXTURE)
    n = STAGES[stage]
    jagent.gp_x, jagent.gp_y = d["gp_x"][:n], d["gp_y"][:, :n]
    if fitted:
        tmpl = _gp_template(jagent)
        leaves = [jnp.asarray(d[f"fit_{i}"])
                  for i in range(len(jax.tree_util.tree_leaves(tmpl)))]
        jagent.gp_params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tmpl),
                                                        leaves)
        jagent.posterior = jagent._build_posterior(jagent._padded_data())
    return jagent


def port_agent(num_basis=200, P=400, horizon=150, **opt):
    """The port's Furuta agent on the CPU, its optimizer cut to P particles
    and ``horizon`` steps (and ``opt``'s fields); the scenario's settings
    otherwise."""
    agent, _ = tfur.build(tfur.FurutaConfig(num_basis=num_basis), "cpu")
    agent.optimizer = dataclasses.replace(agent.optimizer, num_particles=P, horizon=horizon,
                                          **opt)
    return agent


def carried(jagent, dtype=None):
    """The JAX fit in the port's types (``utils/convert``)."""
    return (to_torch(_np(jagent.gp_params), "cpu", dtype, into=tgp.GPParams),
            to_torch(_np(jagent.posterior), "cpu", dtype, into=tgp.Posterior))


@pytest.mark.slow
def test_saved_dataset_is_the_jax_plants():
    """The saved dataset is what the JAX plant makes now, and the saved
    hyperparameters what the JAX fit makes of it (within 1e-4)."""
    jagent = jax_dataset_agent()
    saved = dataset_agent()
    np.testing.assert_array_equal(saved.gp_x, jagent.gp_x)
    np.testing.assert_array_equal(saved.gp_y, jagent.gp_y)
    jagent.fit_model(ModelFitOptions(num_epochs=1501))
    for a, b in zip(jax.tree_util.tree_leaves(saved.gp_params),
                    jax.tree_util.tree_leaves(jagent.gp_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------ (a) the fit


def fit_pair(stage, epochs, f64):
    """Both packages' fits of the stage's data from the same initial
    hyperparameters (the scenario's init): ((losses, params) JAX, (losses,
    params, reverted epochs) port)."""
    jagent = dataset_agent(stage, fitted=False)
    tagent = port_agent()
    x, y, mask = (np.asarray(a) for a in jagent._padded_data())
    ctx = jax.enable_x64() if f64 else contextlib.nullcontext()
    with ctx:
        cast = (lambda a: jnp.asarray(a, jnp.float64)) if f64 else jnp.asarray
        p0 = jax.tree_util.tree_map(cast, _gp_template(jagent))
        data = type(jagent._padded_data())(*(cast(a) for a in (x, y, mask)))
        jp, jl = jax.jit(lambda p, d: jagent.gp.fit(p, d, num_epochs=epochs))(p0, data)
        jp, jl = _np(jp), np.asarray(jl)
    dtype = torch.float64 if f64 else torch.float32
    tdata = tgp.GPData(*(torch.as_tensor(a, dtype=dtype) for a in (x, y, mask)))
    stats = {}
    tp, tl = tagent.gp.fit(to_torch(_np(p0), "cpu", dtype, into=tgp.GPParams), tdata,
                           num_epochs=epochs, stats=stats)
    return (jl, jp), (tl.numpy(), tp, int(stats["reverted"]))


def assert_fits_agree(j, t, rtol_loss=1e-9, rtol_params=1e-8):
    (jl, jp), (tl, tp, _) = j, t
    np.testing.assert_allclose(tl, jl, rtol=rtol_loss)
    for a, b in zip(jax.tree_util.tree_leaves(jp), ckpt_leaves(tp)):
        np.testing.assert_allclose(b, a, rtol=rtol_params, atol=rtol_params * np.abs(a).max())


def ckpt_leaves(tree):
    """The port tree's leaves in JAX's order, as numpy."""
    from mcpilco_tpu_torch.utils.checkpoint import flatten_with_path

    return [v.detach().numpy() for _, v in flatten_with_path(tree)]


def test_fit_float64_matches_jax_on_trial0_data():
    """Tier-1: 300 epochs on trial 0's data (N=150) in float64."""
    j, t = fit_pair("trial 0", 300, f64=True)
    assert_fits_agree(j, t)


@pytest.mark.slow
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_fit_float64_matches_jax_full(stage):
    """The scenario's 1501 epochs on each stage in float64."""
    j, t = fit_pair(stage, 1501, f64=True)
    assert_fits_agree(j, t)


@contextlib.contextmanager
def jax_fit_finiteness(losses, grads):
    """``MultiGP.mll`` of the JAX package wrapped while open: each
    evaluation appends whether its loss is finite to ``losses`` and, in the
    backward, whether its gradient is to ``grads``; the JAX fit's guard
    reverts an epoch whose loss or update is not finite."""
    from mcpilco_tpu.models import gp as jgp

    orig = jgp.MultiGP.mll

    @jax.custom_vjp
    def seen(p):
        return p

    def bwd(_, g):
        jax.debug.callback(lambda *v: grads.append(all(np.isfinite(x).all() for x in v)),
                           *jax.tree_util.tree_leaves(g))
        return (g,)

    seen.defvjp(lambda p: (p, None), bwd)

    def mll(self, p, data, norm):
        out = orig(self, seen(p), data, norm)
        jax.debug.callback(lambda v: losses.append(bool(np.isfinite(v))), out)
        return out

    jgp.MultiGP.mll = mll
    try:
        yield
    finally:
        jgp.MultiGP.mll = orig


def guard_record(stage):
    """Both packages' float32 fits of the stage (1501 epochs): the epochs
    the backtracking guard reverted (the port counts them; on the JAX side,
    the epochs whose loss or gradient is not finite), and the jitter scale
    of the posterior each package builds on its own fit."""
    losses, grads = [], []
    with jax_fit_finiteness(losses, grads):
        (jl, jp), (tl, tp, reverted) = fit_pair(stage, 1501, f64=False)
        jax.effects_barrier()
    assert len(losses) == len(grads) == 1501
    jagent = dataset_agent(stage, fitted=False)
    jagent.gp_params = jax.tree_util.tree_map(jnp.asarray, jp)
    jinfo, tinfo = {}, {}
    jagent._build_posterior(jagent._padded_data(), jinfo)
    tagent = port_agent()
    tagent.gp_params = tp
    tagent._build_posterior(tagent_data(jagent), tinfo)
    bad = int(np.sum(~(np.asarray(losses) & np.asarray(grads))))
    return dict(stage=stage, jax_reverted=bad, port_reverted=reverted,
                jax_jitter=jinfo.get("jitter_scale", 1.0), port_jitter=tinfo["jitter_scale"],
                jax_mll=float(jl[-1]), port_mll=float(tl[-1]))


def tagent_data(jagent):
    return tgp.GPData(*(torch.as_tensor(np.asarray(a)) for a in jagent._padded_data()))


@pytest.mark.slow
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_fit_float32_guard_and_jitter_match_jax(stage):
    rec = guard_record(stage)
    print(rec)
    assert rec["port_reverted"] == rec["jax_reverted"]
    assert rec["port_jitter"] == rec["jax_jitter"]
    np.testing.assert_allclose(rec["port_mll"], rec["jax_mll"], rtol=1e-3)


# ------------------------------------------------------------------ (b) the rollout


@contextlib.contextmanager
def jax_cap_binding(sink):
    """``jroll.RolloutEngine._cap_delta`` wrapped while open: the package's
    cap, then a callback that hands ``sink(bound, mean, var)`` what the cap
    changed ([G, P] bool) and the raw prediction, one call per scan step in
    order (under ``jax.value_and_grad`` the callback receives the raw
    prediction of a float64 rollout rounded to float32; ``bound`` is taken
    in the rollout's own precision)."""
    orig = jroll.RolloutEngine._cap_delta

    def probe(self, posterior, mean, var):
        m, v = orig(self, posterior, mean, var)
        if self.delta_cap is not None:
            bound = ((m != mean) & ~jnp.isnan(mean)) | ((v != var) & ~jnp.isnan(var))
            jax.debug.callback(lambda b, mm, vv: sink(np.array(b), np.array(mm), np.array(vv)),
                               bound, mean, var)
        return m, v

    jroll.RolloutEngine._cap_delta = probe
    try:
        yield
    finally:
        jroll.RolloutEngine._cap_delta = orig


class CapRecord:
    """The calls of a cap probe's sink: ``arrays()`` gives (bound, mean,
    var), each [T-1, G, P]."""

    def __init__(self):
        self.calls = []

    def __call__(self, bound, mean, var):
        self.calls.append(tuple(np.asarray(v.detach() if torch.is_tensor(v) else v)
                                for v in (bound, mean, var)))

    def arrays(self):
        return tuple(np.stack(v) for v in zip(*self.calls))


def rollout_pair(jagent, tagent, pol, P, T, key, p_drop, s0, keep=None, f64=False):
    """Cost, gradient, the cap's record and the states of one rollout in
    both packages on the same draws: ((cost, grads, record, states) JAX,
    (...) port, the cap [G, 1]).  With ``keep`` ([P] bool) the cost and its
    gradient are those of the kept particles' share of the expected cost
    (a particle's rollout is independent of the others'); ``f64``: the
    rollout, the fit and the draws in float64."""
    jeng, teng = jagent.optimizer.engine, tagent.optimizer.engine
    jrec, trec = CapRecord(), CapRecord()
    ctx = jax.enable_x64() if f64 else contextlib.nullcontext()
    dtype = jnp.float64 if f64 else jnp.float32
    with ctx:
        cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
        gp, post, pol = cast(jagent.gp_params), cast(jagent.posterior), cast(pol)

        def cost_j(pp):
            res = jeng.simulate(key, pp, gp, post, jnp.asarray(s0, dtype), T, p_dropout=p_drop)
            if keep is not None:
                stage = jagent.cost.stage_costs(res.states, res.inputs, 0)
                return jnp.sum(stage * jnp.asarray(keep)) / P, res.states
            return jagent.cost(res.states, res.inputs)[0], res.states

        with jax_cap_binding(jrec):
            (cj, sj), gj = jax.jit(jax.value_and_grad(cost_j, has_aux=True))(pol)
            jax.effects_barrier()
        noise = jax_rollout_noise(key, P, T, G, tagent.policy.num_basis, p_drop, dtype=dtype)
        cj, sj, gj = float(cj), np.asarray(sj), {k: np.asarray(v) for k, v in gj.items()}
    tdtype = torch.float64 if f64 else None
    tg, tp = carried(jagent, tdtype)
    leaves = {k: v.clone().requires_grad_(True) for k, v in to_torch(_np(pol), "cpu").items()}
    with delta_cap_binding(trec):
        res = teng.simulate(None, leaves, tg, tp, torch.as_tensor(s0, dtype=tdtype), T,
                            p_dropout=p_drop, noise=noise)
    if keep is None:
        ct, _ = tagent.cost(res.states, res.inputs)
    else:
        ct = torch.sum(tagent.cost.stage_costs(res.states, res.inputs, 0)
                       * torch.as_tensor(keep)) / P
    gt = torch.autograd.grad(ct, list(leaves.values()))
    lim = 3.0 * np.asarray(post.norm)[:, None]
    return ((cj, gj, jrec.arrays(), sj),
            (ct.item(), {k: g.numpy() for k, g in zip(leaves, gt)}, trec.arrays(),
             res.states.detach().numpy()), lim)


# Furuta's angles (theta_h, theta_v): the model reads them through cos and
# sin, so their difference counts in radians, however far they wound
ANGLES = (0, 1)


def parted_particles(sj, st, tol=1e-2):
    """[T, P]: whether a particle's two trajectories have parted by step t
    (an angle apart by more than ``tol`` rad, a velocity by more than
    ``tol`` of max(1, |v|)), and stay parted: off the data the capped
    rollout expands small differences ~10x in 10 steps, in float64 as in
    float32, so such a particle is compared only until it parts."""
    scale = np.maximum(1.0, np.abs(sj))
    scale[..., list(ANGLES)] = 1.0
    far = np.abs(sj - st) > tol * scale
    return np.maximum.accumulate(far.any(-1), axis=0)


def assert_grads_agree(gj, gt):
    for name, g in gt.items():
        scale = float(np.abs(gj[name]).max())
        np.testing.assert_allclose(g, gj[name], rtol=0, atol=1e-3 * scale, err_msg=name)


def rollouts_agree(jagent, tagent, pol, P, T, key, p_drop, s0, f64=False, grads=True):
    """Both packages' rollout (:func:`rollout_pair`): the expected cost,
    with ``grads`` the gradient of the particles whose trajectories never
    part (of every particle where none parts), to their tolerances; then
    the cap's binding (:func:`assert_rollouts_agree`).  Returns its shares,
    the share of particle-steps parted and the particles that parted."""
    j, t, lim = rollout_pair(jagent, tagent, pol, P, T, key, p_drop, s0, f64=f64)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    parted = parted_particles(j[3], t[3])[-1]
    if grads and parted.any():
        gj, gt = (side[1] for side in rollout_pair(jagent, tagent, pol, P, T, key, p_drop, s0,
                                                   keep=~parted, f64=f64)[:2])
        assert_grads_agree(gj, gt)
    elif grads:
        assert_grads_agree(j[1], t[1])
    return assert_rollouts_agree(j, t, lim) + (int(parted.sum()),)


def assert_rollouts_agree(j, t, lim):
    """The cap's binding per step, head and particle up to the particles
    whose raw mean or variance lies within 1% of the cap in either package,
    or whose trajectories have parted (:func:`parted_particles`).  Returns
    the binding share per step and head of both packages ([T-1, G] each)
    and the share of particle-steps left out as parted."""
    (cj, gj, (bj, mj, vj), sj), (ct, gt, (bt, mt, vt), st) = j, t
    assert bj.shape == bt.shape == (len(sj) - 1,) + lim.shape[:1] + sj.shape[1:2]
    near = np.zeros(bj.shape, bool)
    for m, v in ((mj, vj), (mt, vt)):
        near |= (np.abs(np.abs(m) - lim) < 0.01 * lim) | (np.abs(v - lim**2) < 0.01 * lim**2)
    parted = parted_particles(sj, st)[:-1, None, :]  # call k predicts from the state at k
    # a particle far off the data (velocities of ~200 rad/s) feeds the
    # Linear member features that magnify a state difference below the
    # parting threshold: its predictions, compared, part first
    parted = parted | np.any((np.abs(mj - mt) > 0.01 * lim)
                             | (np.abs(vj - vt) > 0.01 * lim**2), axis=1, keepdims=True)
    assert np.all((bj != bt) <= (near | parted)), int(np.sum((bj != bt) & ~(near | parted)))
    assert (bj & bt & ~parted).any()  # the cap binds while the trajectories agree
    return bj.mean(-1), bt.mean(-1), float(parted.mean())


def _policy(num_basis, seed):
    jagent, _ = jfur.build(jfur.FurutaConfig(num_basis=num_basis))
    return jfur.policy_init(jfur.FurutaConfig(num_basis=num_basis), jagent.policy,
                            jprng.root_key(seed))


def _s0(P, seed=0):
    """The scenario's initial particles (var 1e-6 around rest), but for
    particles 0-3, which start with velocities far outside the data, where
    the cap binds."""
    s0 = 1e-3 * np.random.default_rng(seed).standard_normal((P, 4))
    s0[:4, 2:] = [[25.0, -40.0], [-30.0, 35.0], [20.0, 45.0], [-25.0, -30.0]]
    return s0.astype(np.float32)


def test_furuta_rollout_at_full_horizon_cap_binds_and_matches_jax():
    """Tier-1: trial 0's data under the saved hyperparameters, P=16, the
    full horizon of 150 steps, 20 basis functions, dropout 0.25; the cap
    binds (on the particles that start off the data), and at the same
    particles and steps in both packages."""
    jagent = dataset_agent("trial 0")
    tagent = port_agent(num_basis=20, P=16)
    share_j, share_t, parted, _ = rollouts_agree(jagent, tagent, _policy(20, 7), 16, 150,
                                                 jax.random.PRNGKey(3), 0.25, _s0(16))
    print("binding share per head, JAX / port:", share_j.mean(0), share_t.mean(0),
          "parted:", parted)


@pytest.mark.slow
@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_furuta_full_width_rollout_matches_jax(stage, f64):
    """P=400, horizon 150, 200 basis functions on each stage's data under
    the saved hyperparameters, at two policies of the scenario's init (4
    particles start off the data).  In float32 the cost and the cap's
    binding; the gradient in float64: over 150 closed-loop steps at full
    width float32 BPTT parts the two packages' gradients beyond 1e-3 of a
    leaf's largest entry even on particles whose states stay within 1e-2
    (4.5e-5 against 2.56e-5 on 12 of 1,200 centers, trial 0's data, policy
    7, when last run), which float64 does not."""
    jagent = dataset_agent(stage)
    tagent = port_agent()
    for seed in (7, 8):
        share_j, share_t, parted, n = rollouts_agree(
            jagent, tagent, _policy(200, seed), 400, 150, jax.random.PRNGKey(seed), 0.25,
            _s0(400, seed), f64=f64, grads=f64)
        print(f"{stage}, {'float64' if f64 else 'float32'}, policy {seed}: binding share per "
              f"head JAX {share_j.mean(0)}, port {share_t.mean(0)}; particle-steps parted "
              f"{parted} ({n} particles)")


# ------------------------------------------------------------------ (c) the optimizer


def f64_port_side(jagent, tagent, pol, key_seed, num_steps, patch):
    """The port's optimizer of ``tagent`` in float64 on the JAX fit of
    ``jagent``, handed the JAX loop's draws of every step.  Returns (cost
    history, schedule)."""
    from test_torch_pms_fullwidth import _f64_sampling

    _f64_sampling(patch)
    P, T, NB = tagent.optimizer.num_particles, tagent.optimizer.horizon, tagent.policy.num_basis
    with jax.enable_x64():
        jkey, tkey = jax.random.PRNGKey(key_seed), tprng.root_key(key_seed)

        def noise_fn(k):
            n = jax_rollout_noise(jprng.fold(jkey, *k[len(tkey):]), P, T, G, NB, 0.25,
                                  init_dim=4, dtype=jnp.float64, keep_uniforms=True)
            return n._replace(keep=torch.as_tensor(_uniforms_f32(n.keep.numpy())))

        tsched = port_schedule_spy(patch)
        tg, tp = carried(jagent, torch.float64)
        tpol = to_torch(_np(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), pol)),
                        "cpu")
        res = tagent.optimizer.optimize(tkey, tpol, tg, tp, num_steps, 0.01, 0.25, 0,
                                        noise_fn=noise_fn, graph=False, chunk=1)
    return res.cost_history.numpy()[:res.steps_done], tsched


# a monitor that fires within a few dozen steps: every cost change meets
# the threshold, the gate opens after 4 steps and 3 plateau steps
FAST = dict(min_step=4.0, num_min_diff_cost=3, min_diff_cost=1e6)
# the float64 loops at full width part no earlier than this step (10 when
# last run; see the module docstring)
F64_MIN_PART = 8


def test_furuta_small_float64_schedule_matches_jax(monkeypatch):
    """Tier-1: both loops in float64 at P=8, horizon 10, 20 basis on trial
    0's data, with Furuta's alpha, lr_min and dropout reduction and the
    fast monitor: the same events and stop, the histories equal to 1e-6;
    the port's monitor replayed over the JAX history takes them too."""
    reduced = dataset_agent("trial 0")
    jagent = copy.copy(reduced)
    jagent.optimizer = dataclasses.replace(reduced.optimizer, num_particles=8, horizon=10, **FAST)
    tagent = port_agent(num_basis=20, P=8, horizon=10, **FAST)
    pol = _policy(20, 7)
    jside = f64_jax_side(jagent, pol, 11, 60, monkeypatch.setattr)
    tside = f64_port_side(jagent, tagent, pol, 11, 60, monkeypatch.setattr)
    part, jev, tev = assert_schedules_agree(jside, tside, tagent.optimizer, min_part=20)
    assert part is None and jev == tev
    assert len(jev[0]) >= 2 and jev[1] is not None  # reductions and the stop at lr_min
    np.testing.assert_allclose(tside[0], jside[0], rtol=1e-6)


@pytest.mark.slow
def test_furuta_full_width_first_step_float64_matches_jax():
    """The float64 loop's first rollout at full width (all four trials'
    data, its own initial particles and draws from key 11, policy 7): the
    cost to 1e-12 and the gradient to 1e-9 of each leaf's largest entry;
    no particle parts."""
    jagent, tagent = dataset_agent(), port_agent()
    with jax.enable_x64():
        key = jprng.fold(jax.random.PRNGKey(11), 0, 0)
        s0 = np.asarray(jagent.optimizer.init_dist.sample(
            jprng.stream(key, jprng.STREAM_INIT_PARTICLES), 400, dtype=jnp.float64))
    j, t, _ = rollout_pair(jagent, tagent, _policy(200, 7), 400, 150, key, 0.25, s0, f64=True)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-12)
    assert not parted_particles(j[3], t[3]).any()
    for name, g in t[1].items():
        scale = float(np.abs(j[1][name]).max())
        np.testing.assert_allclose(g, j[1][name], rtol=0, atol=1e-9 * scale, err_msg=name)


@pytest.mark.slow
def test_furuta_full_width_optimizer_schedule_matches_jax(monkeypatch):
    """The scenario's monitor in float64 on the same draws, for 1000 steps
    at full width on all four trials' data: the histories part no earlier
    than ``F64_MIN_PART``, and the port's monitor replayed over the JAX
    history takes its schedule exactly (Furuta's first possible plateau
    event is at step 800)."""
    jagent, tagent = dataset_agent(), port_agent()
    pol = _policy(200, 7)
    jside = f64_jax_side(jagent, pol, 11, 1000, monkeypatch.setattr)
    tside = f64_port_side(jagent, tagent, pol, 11, 1000, monkeypatch.setattr)
    part, jev, tev = assert_schedules_agree(jside, tside, tagent.optimizer,
                                            min_part=F64_MIN_PART)
    print(f"cost histories part at step {part} of {len(jside[0])}; events JAX {jev}, port {tev}")


# ------------------------------------------------------------------ (d) the NaN guard


def nan_keys(key_seed, step, retries):
    """The per-iteration keys of ``step`` at the NaN retries ``retries``
    (no re-init before), in both packages' forms."""
    jk = [jprng.fold(jax.random.PRNGKey(key_seed), step, r * (1 << 20)) for r in retries]
    tk = [tprng.fold(tprng.root_key(key_seed), step, r * (1 << 20)) for r in retries]
    return jk, tk


@contextlib.contextmanager
def jax_forced_nan(keys):
    """The JAX rollout's states NaN at the per-iteration keys ``keys``."""
    orig = jroll.RolloutEngine.simulate
    targets = jnp.stack(keys)

    def simulate(self, key, *a, **k):
        res = orig(self, key, *a, **k)
        hit = jnp.any(jnp.all(targets == key, axis=-1))
        return res._replace(states=res.states * jnp.where(hit, jnp.nan, 1.0))

    jroll.RolloutEngine.simulate = simulate
    try:
        yield
    finally:
        jroll.RolloutEngine.simulate = orig


RESET_FIELDS = ("lr", "p_drop", "thr", "gate_step", "consec", "es1", "es2", "dcr", "cost_prev")


def jax_nan_side(jagent, pol, key_seed, num_steps, nan_step, retries):
    """The JAX loop, one step per chunk, NaN forced at ``nan_step`` for the
    retries ``retries``.  Returns (the final carry, the carry after
    ``nan_step``'s chunk)."""
    jax.clear_caches()
    jk, _ = nan_keys(key_seed, nan_step, retries)
    opt = jagent.optimizer
    key = jax.random.PRNGKey(key_seed)
    with jax_forced_nan(jk):
        carry = opt._optimize_init(key, pol, jagent.gp_params, jagent.posterior, 0.01, 0.25, 0,
                                   jnp.zeros((), jnp.int32))
        after = None
        for s in range(num_steps):
            carry = opt._optimize_chunk(carry, key, jagent.gp_params, jagent.posterior,
                                        jnp.int32(s + 1), carry.iters + 64, 0)
            if s == nan_step:
                after = carry
    return carry, after


def port_nan_side(jagent, tagent, pol, key_seed, num_steps, nan_step, retries, monkeypatch):
    """The port's loop on the JAX fit and the JAX draws, NaN forced at the
    same keys.  Returns (the result, iterations run, the lane's state after
    the re-init of ``nan_step`` or None)."""
    P, T, NB = tagent.optimizer.num_particles, tagent.optimizer.horizon, tagent.policy.num_basis
    jkey, tkey = jax.random.PRNGKey(key_seed), tprng.root_key(key_seed)
    _, bad = nan_keys(key_seed, nan_step, retries)

    def noise_fn(k):
        n = jax_rollout_noise(jprng.fold(jkey, *k[len(tkey):]), P, T, G, NB, 0.25, init_dim=4)
        if tuple(k) in {tuple(b) for b in bad}:
            n = n._replace(state=torch.full_like(n.state, float("nan")))
        return n

    seen = {}
    restart = ttrainer.PolicyOptimizer._restart

    def spy(self, buf, halted, give_up, lr0, p_dropout0):
        restart(self, buf, halted, give_up, lr0, p_dropout0)
        if give_up:
            seen.update({k: float(v[0]) for k, v in buf.lane.items()})
            seen["leaves"] = {k: v[0].clone() for k, v in buf.leaves.items()}
            seen["adam"] = [float(t.abs().max()) for s in (buf.m, buf.v) for t in s.values()]

    monkeypatch.setattr(ttrainer.PolicyOptimizer, "_restart", spy)
    before = dict(ttrainer.graph_counts)
    tg, tp = carried(jagent)
    res = tagent.optimizer.optimize(tkey, to_torch(_np(pol), "cpu"), tg, tp, num_steps, 0.01,
                                    0.25, 0, noise_fn=noise_fn, graph=False, chunk=1)
    iters = ttrainer.graph_counts["uncaptured"] - before["uncaptured"]
    return res, iters, seen or None


@pytest.mark.parametrize("retries", [(0,), (0, 1, 2, 3)], ids=["resample", "give-up"])
def test_furuta_nan_guard_schedule_matches_jax(retries, monkeypatch):
    """Tier-1 at P=8, horizon 10, 20 basis, ``max_nan_retries`` 3, the NaN
    forced at step 3: one NaN re-samples once and the step goes on; four in
    a row give up, log the step with the last cost, re-initialize the
    policy, Adam and the monitor, and go on from the next step.  Both
    packages take the same number of iterations for the same steps."""
    reduced = dataset_agent("trial 0")
    jagent = copy.copy(reduced)
    jagent.optimizer = dataclasses.replace(reduced.optimizer, num_particles=8, horizon=10,
                                           max_nan_retries=3)
    tagent = port_agent(num_basis=20, P=8, horizon=10, max_nan_retries=3)
    pol = _policy(20, 7)
    steps, at = 6, 3
    jcarry, jafter = jax_nan_side(jagent, pol, 5, steps, at, retries)
    res, iters, tafter = port_nan_side(jagent, tagent, pol, 5, steps, at, retries, monkeypatch)
    give_up = len(retries) > 3
    assert int(jcarry.step) == res.steps_done == steps
    assert int(jcarry.iters) == iters == steps + len(retries) - give_up
    assert int(jcarry.reinit_count) == res.reinit_count == int(give_up)
    jcost = np.asarray(jcarry.cost_hist)[:steps]
    tcost = res.cost_history.numpy()[:steps]
    upto = at if give_up else steps
    np.testing.assert_allclose(tcost[:upto], jcost[:upto], rtol=1e-5)
    if not give_up:
        assert tafter is None
        return
    # the give-up step logs the last cost (cost_prev) and a zero std
    for hist, std in ((jcost, np.asarray(jcarry.std_hist)), (tcost, res.std_history.numpy())):
        assert hist[at] == hist[at - 1] and std[at] == 0.0
    # the same fields reset to the same values, the same leaves redrawn
    for name in RESET_FIELDS:
        assert float(getattr(jafter, name)) == pytest.approx(tafter[name], rel=1e-7), name
    assert tafter["adam_count"] == 0 and max(tafter["adam"]) == 0.0
    assert all(float(jnp.max(jnp.abs(t))) == 0.0
               for t in jax.tree_util.tree_leaves((jafter.adam.m, jafter.adam.v)))
    assert int(jafter.adam.count) == 0
    jpre = _np(pol)
    for name, leaf in tafter["leaves"].items():
        jchanged = not np.array_equal(np.asarray(jafter.params[name]), jpre[name])
        tchanged = not np.array_equal(leaf.detach().numpy(), jpre[name])
        assert jchanged == tchanged, name


# ------------------------------------------------------------------ the script


def schedule_side(package, steps, threads):
    """One package's side of :func:`test_furuta_full_width_optimizer_schedule_matches_jax`
    as a row: its cost history, schedule and events (and for JAX the probe
    cost)."""
    t0 = time.time()
    torch.set_num_threads(threads)
    jagent, pol = dataset_agent(), _policy(200, 7)
    if package == "jax":
        costs, sched, cost0 = f64_jax_side(jagent, pol, 11, steps, setattr)
    else:
        (costs, sched), cost0 = f64_port_side(jagent, port_agent(), pol, 11, steps, setattr), None
    ev, stop = ttrainer.schedule_events(sched)
    return dict(package=package, steps=steps, threads=threads, costs=costs.tolist(),
                sched=sched, events=ev, stop_step=stop, cost0=cost0, seconds=time.time() - t0)


def compare_sides(jax_row, port_row):
    """The slow test's checks on two rows of :func:`schedule_side`:
    returns (parting step, the JAX events, the port's)."""
    jside = (np.asarray(jax_row["costs"], np.float32), jax_row["sched"], jax_row["cost0"])
    tside = (np.asarray(port_row["costs"], np.float32), port_row["sched"])
    return assert_schedules_agree(jside, tside, port_agent().optimizer, min_part=F64_MIN_PART)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("dataset", help="make and save the dataset and its fit")
    s.add_argument("--out", default=FIXTURE)
    sub.add_parser("guard", help="print the float32 fits' guard and jitter records")
    f = sub.add_parser("schedule", help="one package's side of the full-width float64 loop")
    f.add_argument("--package", choices=("jax", "port"), required=True)
    f.add_argument("--steps", type=int, default=1000)
    f.add_argument("--threads", type=int, default=4)
    f.add_argument("--out", required=True)
    c = sub.add_parser("compare", help="the float64 loop's checks on two sides' rows")
    c.add_argument("jax_row")
    c.add_argument("port_row")
    args = p.parse_args(argv)
    if args.cmd == "dataset":
        save_dataset(args.out)
    elif args.cmd == "schedule":
        with open(args.out, "w") as out:
            json.dump(schedule_side(args.package, args.steps, args.threads), out)
    elif args.cmd == "compare":
        rows = [json.load(open(path)) for path in (args.jax_row, args.port_row)]
        part, jev, tev = compare_sides(*rows)
        print(f"cost histories part at step {part} of {len(rows[0]['costs'])}; identical to "
              f"step {parting_step(*(np.asarray(r['costs'], np.float32) for r in rows), rtol=0.0)}"
              f"; events JAX {jev}, port {tev}; the port's monitor replayed over the JAX "
              f"history takes JAX's")
    else:
        for stage in STAGES:
            print(guard_record(stage))


if __name__ == "__main__":
    main()
