"""The port's multi-device path on the CPU: ranks over gloo, at 2 and 4.

``parallel/mesh.py`` (meshes, sharding, ``replicate``, the rank launcher),
``parallel/shard.py``, ``parallel/dryrun.py`` and the mesh hooks of
``PolicyOptimizer``, ``SeedFarm``, ``MCPilco`` and ``cartpole.build``,
against the same computations without a mesh in this process
(``dryrun.reference``) and against the JAX package's sharded round on a
4-device virtual mesh.  Each launch spawns its ranks once and runs every
check in them (``dryrun.worker``).

Tolerances.  Particle sharding sums each shard's particles first, then the
shards: JAX's own tolerances for that (tests/test_parallel.py:40-58): the
cost history rtol 2e-4, atol 1e-5, the same steps, the final parameters
rtol 1e-3, atol 1e-5.  Seed sharding adds no arithmetic, so each seed
group's farm is bitwise the one-process farm of the same seeds (a seed's
bits depend on how many seeds share its batch, on the CPU as on the card,
so a group is held against a farm of its own seeds); a 2D farm whose
particle axis has one shard too, while two particle shards hold it to the
tolerances above (and its executed trial to JAX's end-to-end rtol 1e-3,
atol 5e-3).  A mesh of one rank is bitwise the run without a mesh.  Against JAX (the same numpy
inputs, JAX's draws handed in): the GP fit rtol 1e-4 (5 Adam epochs in two
frameworks' float32), the costs rtol 1e-3 and the parameters atol 1e-5 as
tests/test_torch_slice.py holds one unsharded round.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
from _torch_parity import assert_same_config, jax_rollout_noise
from mcpilco_tpu.parallel import mesh as jmesh
from mcpilco_tpu.parallel.shard import sharded_training_round as jax_round
from mcpilco_tpu.utils import prng as jprng
from mcpilco_tpu_torch.models.costs import expected_cost
from mcpilco_tpu_torch.models.gp import GPData, GPParams
from mcpilco_tpu_torch.parallel import dryrun
from mcpilco_tpu_torch.parallel import mesh as tmesh
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

COST_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
JAX_STEPS = 6


def _stage():
    """Stage costs [T=3, L=2, P=16] near 1000 whose four particle shards sit
    at different means: the float32 one-pass variance E[x^2] - E[x]^2
    cancels to noise there, the two-pass one does not."""
    rng = np.random.default_rng(0)
    shard_mean = np.repeat([-0.75, -0.25, 0.25, 0.75], 4)
    return (1000.0 + shard_mean + 1e-2 * rng.standard_normal((3, 2, 16))).astype(np.float32)


def _tie_stage():
    """Stage costs [T=1, L=64, P=16] whose first particle shard of four
    sums, in every lane, to a value 16 * a whose share a of the mean sits
    half an ulp of the mean off the mean's grid: b - a then rounds on a
    tie, and a + fl(b - a) comes back to the mean b only where b's last bit
    is even.  A form that rebuilt the mean from the shard's share would
    differ between ranks by one ulp in about half the lanes."""
    rng = np.random.default_rng(1)
    ulp = 2.0 ** -21  # of the shard sum ~6; the particles' values stay on it
    k = rng.integers(0, 2 ** 14, size=(1, 64, 16))
    k[..., 3] += (2 - k[..., :4].sum(axis=-1)) % 4  # shard 0's sum: 2 mod 4 ulps
    base = np.where(np.arange(16) < 4, 1.5, 1.75)
    return (base + k * ulp).astype(np.float32)


def _group_farms(farm, size):
    """The one-process farms of each group of ``size`` seeds, joined."""
    seeds = list(farm["seeds"])
    return dryrun.join_farms([dryrun.run_farm(dict(farm, seeds=seeds[i:i + size]))
                              for i in range(0, len(seeds), size)])


def _jax_round():
    """JAX's sharded round on a 4-device virtual mesh, and the port's
    inputs for the same round: the converted numpy inputs and a table of
    JAX's draws for every key the port's optimizer asks for."""
    opt, pol, gpp, _, data, _, key = graft._tiny_setup(num_particles=16)
    out = jax_round(dataclasses.replace(opt, mesh=jmesh.make_mesh(4)), gpp, data, pol, key,
                    num_gp_epochs=5, num_opt_steps=JAX_STEPS)
    jax.block_until_ready(out.opt.cost_history)
    tnp = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    st = dryrun.tiny_setup(16, device="cpu")
    assert_same_config(opt, st.optimizer, "optimizer")
    tkey = tprng.root_key(0)
    P, T = opt.num_particles, opt.horizon
    wanted = [(0x9999,)] + [(s, 0) for s in range(JAX_STEPS)]
    table = {tprng.fold(tkey, *c): jax_rollout_noise(jprng.fold(key, *c), P, T, 2,
                                                    opt.engine.policy.num_basis, 0.0, init_dim=4)
             for c in wanted}
    spec = dict(kind="round", optimizer=st.optimizer, policy_params=to_torch(tnp(pol), "cpu"),
                gp_params=to_torch(tnp(gpp), "cpu", into=GPParams),
                data=GPData(*(torch.as_tensor(np.array(v)) for v in data)), key=tkey,
                lr0=0.01, p_dropout0=0.0, epochs=5, steps=JAX_STEPS, noise_fn=table.__getitem__)
    return spec, jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def runs():
    """Every check at 4 ranks (the errors, the expected cost, the train
    step and the JAX round too), at 2 ranks (the 2D farm on a (2, 1) mesh),
    the references in this process (the farms of 1 and of 2 seeds), and
    the round and step at world 1."""
    spec = dryrun.tiny_spec("cpu")
    step = dict(spec["round"], kind="step")
    jax_spec, jax_out = _jax_round()
    costs = dict(cost=dict(kind="cost", stage=_stage()), ties=dict(kind="cost",
                                                                   stage=_tie_stage()))
    spec4 = dict(spec, errors=dict(kind="errors", farm=spec["farm"]), step=step, jax=jax_spec,
                 **costs)
    launch = tmesh.start(dryrun.worker, 4, "cpu", args=(spec4, False))
    ref = dryrun.reference(dict(round=spec["round"], restart=spec["restart"]))
    groups = {size: _group_farms(spec["farm"], size) for size in (1, 2)}
    out4 = launch.join(timeout=300)
    spec2 = dict(spec, farm2d=dict(spec["farm"], mesh=(2, 1)), **costs)
    out2 = tmesh.launch(dryrun.worker, 2, "cpu", args=(spec2, False), timeout=300)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rdv"),
                                world_size=1, rank=0)
        try:
            world1 = dryrun.worker(dict(round=spec["round"], step=step), verbose=False)
        finally:
            dist.destroy_process_group()
    return dict(spec=spec, ref=ref, groups=groups, ranks={2: out2, 4: out4}, world1=world1,
                jax=jax_out)


def _close(a, b, tol, what):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=f"{what}: {k}", **tol)


def _same(a, b, what):
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_particle_sharded_round_matches_the_unsharded_port(runs, n):
    """(a) The GP fit and 8 optimizer steps (chunks of 4) with 16 particles
    over n ranks, against the same round without a mesh."""
    got, want = runs["ranks"][n][0]["round"], runs["ref"]["round"]
    assert got["steps_done"] == want["steps_done"] == 8
    np.testing.assert_array_equal(got["mll_history"], want["mll_history"])  # unsharded fit
    np.testing.assert_allclose(got["cost_history"], want["cost_history"], **COST_TOL)
    _close(got["params"], want["params"], PARAM_TOL, "params")
    # the last rollout, gathered from the shards, at the final parameters:
    # their differences (PARAM_TOL) carried through 10 closed-loop steps
    assert got["states"].shape == want["states"].shape == (10, 16, 4)
    np.testing.assert_allclose(got["states"], want["states"], rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_hold_identical_results(runs, n):
    """Replicated state and summed gradients: every rank ends each check
    with the same bits."""
    outs = runs["ranks"][n]
    for check in ("round", "restart"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[check]["cost_history"],
                                          outs[0][check]["cost_history"])
            _same(o[check]["params"], outs[0][check]["params"], check)
    for o in outs[1:]:
        _same(o["farm"]["params"], outs[0]["farm"]["params"], "farm")


def test_a_mesh_of_one_rank_is_bitwise_the_run_without_one(runs):
    got, want = runs["world1"]["round"], runs["ref"]["round"]
    np.testing.assert_array_equal(got["cost_history"], want["cost_history"])
    _same(got["params"], want["params"], "params")
    np.testing.assert_array_equal(got["states"], want["states"])


@pytest.mark.parametrize("n", [2, 4])
def test_seed_sharded_farm_is_bitwise_the_one_process_farm(runs, n):
    """(b) Seeds 1-4 over n seed groups against the seeds of each group
    farmed in one process: every trial log and the policies bitwise, in
    seed order."""
    got, want = runs["ranks"][n][0]["farm"], runs["groups"][4 // n]
    np.testing.assert_array_equal(got["seeds"], want["seeds"])
    assert got["local_seeds"] == [1, 2, 3, 4][: 4 // n]
    for g, w in zip(got["logs"], want["logs"]):
        _same(g, {k: v for k, v in w.items() if k != "wall_clock_s"}, "farm log")
    _same(got["params"], want["params"], "farm params")


@pytest.mark.parametrize("n", [2, 4])
def test_2d_seed_particle_farm(runs, n):
    """(b) The farm on a 2D ("s", "p") mesh, its optimizer on the same mesh,
    against the one-process farms of its two seed groups: at 2 ranks one
    particle shard per group (bitwise), at 4 two particle shards (within
    the particle tolerance)."""
    got, want = runs["ranks"][n][0]["farm2d"], runs["groups"][2]
    for g, w in zip(got["logs"], want["logs"]):
        np.testing.assert_array_equal(g["steps_done"], w["steps_done"])
        if n == 2:
            _same(g, {k: v for k, v in w.items() if k != "wall_clock_s"}, "2D farm log")
        else:
            np.testing.assert_allclose(g["cost_history"], w["cost_history"], **COST_TOL)
            np.testing.assert_allclose(g["control_true"], w["control_true"], rtol=1e-3,
                                       atol=5e-3)
    if n == 4:
        _close(got["params"], want["params"], PARAM_TOL, "2D farm params")


@pytest.mark.parametrize("n", [2, 4])
def test_restart_particle_mesh_picks_the_unsharded_winner(runs, n):
    """(c) Four restart lanes over a (n/2, 2) restart x particle mesh."""
    got, want = runs["ranks"][n][0]["restart"], runs["ref"]["restart"]
    assert got["restart_winner"] == want["restart_winner"]
    np.testing.assert_allclose(got["restart_costs"], want["restart_costs"], **COST_TOL)
    np.testing.assert_allclose(got["cost_history"], want["cost_history"], **COST_TOL)
    _close(got["params"], want["params"], PARAM_TOL, "winner params")
    assert got["steps_done"] == want["steps_done"]


@pytest.mark.parametrize("case, error, match", [
    ("restart axis, one restart", "ValueError", "num_restarts == 1"),
    ("restarts do not tile", "ValueError", "does not tile the mesh's restart axis"),
    ("sequential restart lanes", "ValueError", "restart_vmap=False"),
    ("farm over an optimizer's particle mesh", "ValueError", "shared 2D"),
    ("seeds do not tile", "ValueError", "seeds do not tile the mesh's 4 seed group"),
    ("unequal device-body runs", "RuntimeError", "0 to 3 times"),
])
def test_mesh_refusals(runs, case, error, match):
    """(d) The JAX package's ValueErrors (control/trainer.py:303-319,
    parallel/multiseed.py:127-157) in the same cases, and the check that
    the ranks of a particle group ran the device body equally often, on
    every rank."""
    for out in runs["ranks"][4]:
        got = out["errors"][case]
        assert got is not None, case
        assert got[0] == error and match in got[1], got


@pytest.mark.parametrize("n", [2, 4])
def test_expected_cost_over_particle_shards(runs, n):
    """(f) The mean and the two-pass std over shards whose means differ,
    against float64 over all particles; the one-pass float32 form would be
    far off here.  The ranks' gradients together are d(mean)/d(particle)."""
    stage = _stage()
    outs = [o["cost"] for o in runs["ranks"][n]]
    x = stage.astype(np.float64)
    mean = x.mean(axis=2).sum(axis=0)
    std = x.std(axis=2, ddof=1).sum(axis=0)
    for o in outs:
        np.testing.assert_allclose(o["cost"], mean, rtol=1e-6)
        np.testing.assert_allclose(o["std"], std, rtol=1e-4)
    one_pass = np.sqrt(np.maximum((stage * stage).mean(axis=2) - stage.mean(axis=2) ** 2, 0.0)
                       * 16 / 15).sum(axis=0)
    assert np.max(np.abs(one_pass - std)) > 100 * np.max(np.abs(outs[0]["std"] - std))
    grad = np.concatenate([o["grad"] for o in outs], axis=2)
    np.testing.assert_array_equal(grad, np.full(stage.shape, np.float32(1 / 16)))
    cost, sd = expected_cost(torch.as_tensor(stage))
    np.testing.assert_allclose(outs[0]["cost"], cost.numpy(), rtol=1e-6)
    np.testing.assert_allclose(outs[0]["std"], sd.numpy(), rtol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("check", ["cost", "ties"])
def test_expected_cost_is_the_same_on_every_rank(runs, n, check):
    """Every rank of the particle group reads the same bits of the cost and
    std (they take the monitor's, keep-best's and the lane stops' decisions
    on them), also where the shard's share of the mean rounds on a tie
    (``_tie_stage``), and the mean is the float64 mean's within an ulp or
    two."""
    outs = [o[check] for o in runs["ranks"][n]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["cost"], outs[0]["cost"])
        np.testing.assert_array_equal(o["std"], outs[0]["std"])
    stage = (_stage() if check == "cost" else _tie_stage()).astype(np.float64)
    np.testing.assert_allclose(outs[0]["cost"], stage.mean(axis=2).sum(axis=0), rtol=1e-6)


def test_sharded_train_step_matches_one_rank(runs):
    """``make_sharded_train_step`` on 4 ranks against 1 (the JAX package's
    TestShardedTrainStep, 1 against 8 devices)."""
    got, want = runs["ranks"][4][0]["step"], runs["world1"]["step"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    np.testing.assert_array_equal(got["mll"], want["mll"])
    _close(got["params"], want["params"], PARAM_TOL, "step params")


def test_sharded_training_round_matches_jax(runs):
    """(e) ``sharded_training_round`` on 4 gloo ranks against the JAX
    package's on a 4-device virtual mesh: the same numpy inputs, JAX's draws
    handed in."""
    got, want = runs["ranks"][4][0]["jax"], runs["jax"]
    np.testing.assert_allclose(got["mll_history"], want.mll_history, rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(got["gp_params"]),
                    jax.tree_util.tree_leaves(want.gp_params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert got["steps_done"] == int(want.opt.steps_done) == JAX_STEPS
    np.testing.assert_allclose(got["cost_history"], want.opt.cost_history, rtol=1e-3)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want.opt.policy_params[k], atol=1e-5, err_msg=k)


def test_dryrun_entry_point_on_two_ranks():
    """``python -m mcpilco_tpu_torch.parallel.dryrun --ranks 2 --device cpu``
    prints its four checks."""
    out = subprocess.run([sys.executable, "-m", "mcpilco_tpu_torch.parallel.dryrun", "--ranks",
                          "2", "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[dryrun]")]
    for what in ("2-rank particle mesh OK", "seed farm OK", "2D seed x particle mesh OK",
                 "restart x particle mesh OK"):
        assert any(what in ln for ln in lines), out.stdout


def test_launch_refuses_missing_cards():
    """No fallback: NCCL ranks without as many cards raise, before any
    process starts."""
    with pytest.raises(RuntimeError, match="NCCL ranks need"):
        tmesh.start(dryrun.worker, torch.cuda.device_count() + 1, "cuda", args=({},))
