"""The multi-device check: four sharded paths on N ranks, one line each.

The port of ``__graft_entry__._dryrun_worker`` / ``dryrun_multichip``:

    python -m mcpilco_tpu_torch.parallel.dryrun --ranks N [--device cpu]

spawns N ranks (NCCL, one card each; or gloo on the CPU) and runs on them:

1. a particle-sharded training round (``shard.sharded_training_round``:
   the GP fit, then the policy optimizer with P particles over N ranks);
2. the seed farm with its seeds over the N ranks (``SeedFarm.mesh``);
3. the farm on a 2D seed x particle mesh (``make_seed_particle_mesh``);
4. restart lanes over a 2D restart x particle mesh
   (``make_restart_particle_mesh``).

Each check returns its results as numpy (:func:`worker`); :func:`reference`
runs the same computations without a mesh in one process, which the tests
and ``chip_smoke.py`` hold the ranks' results against.  The default inputs
are a miniature flagship (:func:`tiny_setup`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..control.rollout import InitialStateDistribution, RolloutEngine
from ..control.trainer import PolicyOptimizer, graph_counts, reset_graph_counts
from ..models import kernels as K
from ..models.costs import CartPoleCost
from ..models.dynamics import SpeedIntegration
from ..models.gp import GPData, MultiGP, tree_map
from ..models.policies import SumOfGaussiansWithAngles
from ..ops import fused_predict as fp
from ..scenarios import cartpole
from ..utils import prng
from . import mesh as mesh_mod
from .multiseed import SeedFarm
from .shard import sharded_training_round


class Setup(NamedTuple):
    optimizer: PolicyOptimizer
    policy_params: dict
    gp_params: object
    gp: MultiGP
    data: GPData
    posterior: object
    key: tuple


def tiny_setup(num_particles=16, horizon=10, num_basis=16, n_data=24, cap=32,
               device="cuda") -> Setup:
    """A miniature flagship (cart-pole, SE+P(2) GP, RBF policy), as
    ``__graft_entry__._tiny_setup`` builds it: random states and inputs as
    data, untrained GP hyperparameters with small polynomial weights.  The
    draws come from a CPU generator, so every device gets the same inputs."""
    model = SpeedIntegration(state_dim=4, input_dim=1, dt=0.05, vel_indices=(1, 3),
                             pos_indices=(0, 2), angle_indices=(2,), not_angle_indices=(0, 1, 3))
    gp = MultiGP(kernel=K.se_plus_volterra(active_dims=tuple(range(6)), degree=2), num_heads=2)
    policy = SumOfGaussiansWithAngles(feature_dim=5, input_dim=1, num_basis=num_basis, u_max=10.0,
                                      angle_indices=(2,), non_angle_indices=(0, 1, 3))
    cost = CartPoleCost(target_state=(3.14159, 0.0), lengthscales=(3.0, 1.0))
    init_dist = InitialStateDistribution(kind="gaussian", mean=[0.0] * 4, var=[1e-4] * 4)
    optimizer = PolicyOptimizer(
        engine=RolloutEngine(model=model, gp=gp, policy=policy), cost=cost, init_dist=init_dist,
        num_particles=num_particles, horizon=horizon, max_opt_steps=8, min_step=2.0,
        num_min_diff_cost=4)
    key = prng.root_key(0)
    gen = prng.generator(prng.fold(key, 1), "cpu")
    s = 0.3 * torch.randn((n_data + 1, 4), generator=gen)
    u = torch.randn((n_data + 1, 1), generator=gen)
    x, y = model.training_pairs(s, u)
    n = x.shape[0]
    xp, yp = torch.zeros((cap, x.shape[1])), torch.zeros((y.shape[0], cap))
    xp[:n], yp[:, :n] = x, y
    mask = (torch.arange(cap) < n).float()
    data = GPData(*(t.to(device) for t in (xp, yp, mask)))
    overrides = [{"member_overrides": [{}, {"sigma_diag": 0.01}, {"sigma_diag": 0.01}]}] * 2
    gp_params = gp.init_params(sigma_n=0.2, per_head_overrides=overrides, device=device)
    policy_params = policy.init_params(prng.fold(key, 2), device=device)
    return Setup(optimizer, policy_params, gp_params, gp, data, gp.fit_posterior(gp_params, data),
                 key)


def tiny_spec(device="cuda"):
    """The inputs of the four checks at the miniature size: the round (16
    particles; a 5-epoch fit, then 8 steps read in chunks of 4), 4 restart
    lanes of 8 steps, and the smoke farm (16 particles, 16 basis functions,
    10-epoch fits, 6 steps) over seeds 1-4.  The inputs are host tensors;
    ``device`` is where :func:`reference` runs (a rank runs on its own)."""
    st = tiny_setup(16, device="cpu")
    cfg = dataclasses.replace(cartpole.CartpoleConfig(seed=1).smoke(), num_particles=16,
                              opt_steps=(6,), gp_epochs=10, num_basis=16)
    inputs = dict(optimizer=st.optimizer, policy_params=st.policy_params,
                  gp_params=st.gp_params, data=st.data, key=st.key, lr0=0.01, p_dropout0=0.0,
                  steps=8, chunk=4, device=device)
    farm = dict(cfg=cfg, seeds=[1, 2, 3, 4], device=device)
    return dict(round=dict(inputs, epochs=5), farm=farm, farm2d=farm,
                restart=dict(inputs, restarts=4))


def _to(tree, dev):
    return tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, tree)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
                    tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _opt_out(res) -> dict:
    steps = int(res.steps_done)
    return dict(cost_history=_np(res.cost_history), steps_done=steps,
                params=_np(res.policy_params), states=_np(res.states),
                restart_costs=res.restart_costs, restart_winner=res.restart_winner)


def run_round(spec: dict, mesh=None) -> dict:
    """Check 1: the GP fit and ``steps`` optimizer steps from the spec's
    inputs (``noise_fn`` among them, if any), particle-sharded over ``mesh``
    (``sharded_training_round``) or on one device.  Returns the round's
    results (numpy), and with ``spec['profile']`` (a window of steps) the
    step's profile (:func:`profile_round`).  ``spec['order']`` (one device
    only): a permutation of the particles, applied to the default draws
    (:func:`permuted_noise`), which changes only the order of the sums over
    particles."""
    dev = torch.device(spec.get("device", "cuda")) if mesh is None else mesh.device
    s = _to(spec, dev)
    opt = dataclasses.replace(s["optimizer"], mesh=mesh)
    gp = opt.engine.gp
    noise_fn = s.get("noise_fn")
    if s.get("order") is not None:
        noise_fn = permuted_noise(opt, s["p_dropout0"], dev, s["order"])
    fp.reset_launches()
    reset_graph_counts()
    if mesh is None:
        gp_params, mll = gp.fit(s["gp_params"], s["data"], num_epochs=s["epochs"],
                                learning_rate=0.01)
        post = gp.fit_posterior(gp_params, s["data"])
        res = opt.optimize(s["key"], s["policy_params"], gp_params, post, s["steps"], s["lr0"],
                           s["p_dropout0"], noise_fn=noise_fn, chunk=s.get("chunk"))
    else:
        out = sharded_training_round(opt, s["gp_params"], s["data"], s["policy_params"], s["key"],
                                     num_gp_epochs=s["epochs"], num_opt_steps=s["steps"],
                                     lr0=s["lr0"], p_dropout0=s["p_dropout0"], noise_fn=noise_fn,
                                     chunk=s.get("chunk"))
        gp_params, mll, res = out.gp_params, out.mll_history, out.opt
        post = gp.fit_posterior(gp_params, s["data"])
    _sync(dev)
    out = dict(_opt_out(res), mll_history=_np(mll), gp_params=_np(gp_params),
               launches=dict(fp.launches), graph=dict(graph_counts), device=str(dev))
    if spec.get("profile"):
        out["profile"] = profile_round(opt, s, gp_params, post, spec["profile"], out["graph"])
    return out


def permuted_noise(opt, p_dropout0, dev, order):
    """A ``noise_fn`` that hands the optimizer its own default draws (those
    of ``PolicyOptimizer.optimize`` without one) with the particles in
    ``order``."""
    from ..control.rollout import RolloutNoise

    idx = torch.as_tensor(np.asarray(order), device=dev)
    engine, P, T = opt.engine, opt.num_particles, opt.horizon
    take = lambda t, dim: None if t is None else t.index_select(dim, idx)

    def fn(k):
        n = engine.draw_noise(k, P, T, p_dropout0, dev, init_dist=opt.init_dist,
                              keep_uniforms=True)
        return RolloutNoise(state=take(n.state, 1), keep=take(n.keep, 1), init=take(n.init, 0),
                            meas=take(n.meas, 1), init_idx=take(n.init_idx, 0))
    return fn


def profile_round(opt, s, gp_params, post, window: int, counts: dict) -> dict:
    """The round's optimizer step: host ms per step from the round's own
    call (``counts``: its ``graph_counts``; the replays' seconds over the
    replays), then, on the card, one profiled call of GRAPH_BASE +
    ``window`` steps, read per replay of its graph (the device records that
    share the replay's correlation id): device busy ms, of it the NCCL
    kernels' us (their time includes waiting for the other ranks), device
    events, NCCL kernels and K1/K2 per step.  Every rank makes the same one
    call, so their collectives pair up; a window short of records is
    reported, not profiled again."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import GRAPH_BASE, REPLAY_MIN

    kind = "replays" if counts["replays"] else "uncaptured"
    out = dict(host_ms=1e3 * counts[kind + "_s"] / counts[kind])
    dev = post.x_tr.device
    if dev.type != "cuda":
        return out
    reset_graph_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.optimize(prng.fold(s["key"], 3), s["policy_params"], gp_params, post,
                     GRAPH_BASE + window, s["lr0"], s["p_dropout0"])
        _sync(dev)
    groups = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not getattr(e, "is_hidden_event",
                                                              lambda: False)():
            groups[e.correlation_id()].append((e.name(), e.duration_ns() / 1e3))
    replays = [g for g in groups.values() if len(g) >= REPLAY_MIN]
    out["replays_seen"], out["replays_run"] = len(replays), graph_counts["replays"]
    if not replays or len(replays) != graph_counts["replays"]:
        return out
    per = lambda f: sum(f(g) for g in replays) / len(replays)
    nccl = lambda g: [t for name, t in g if "nccl" in name.lower()]
    count = lambda g, what: sum(what in name for name, _ in g)
    out.update(busy_ms=per(lambda g: sum(t for _, t in g)) / 1e3, events=per(len),
               nccl_calls=per(lambda g: len(nccl(g))), nccl_us=per(lambda g: sum(nccl(g))),
               k1_per_step=per(lambda g: count(g, "k1_forward")),
               k2_per_step=per(lambda g: count(g, "k2_backward")))
    out["busy_ex_nccl_ms"] = out["busy_ms"] - out["nccl_us"] / 1e3
    out["idle"] = 1.0 - out["busy_ex_nccl_ms"] / out["host_ms"]
    return out


def run_farm(spec: dict, mesh=None, two_d: bool = False) -> dict:
    """Checks 2 and 3: ``SeedFarm.run`` of the spec's config over its seeds:
    over the seed groups of ``mesh``, its optimizer on the same mesh when
    ``two_d``, or in one process.  Returns every seed's logs (numpy, seed
    order) and the seed-steps per second of the replays (this rank's seeds
    over the host seconds per replay)."""
    dev = torch.device(spec.get("device", "cuda")) if mesh is None else mesh.device
    cfg = spec["cfg"]
    agent, kwargs = cartpole.build(cfg, dev, mesh=mesh if two_d else None)
    farm = SeedFarm(agent, list(spec["seeds"]), mesh=mesh,
                    policy_init_fn=lambda k: cartpole.policy_init(cfg, agent.policy, k, dev))
    reset_graph_counts()
    fp.reset_launches()
    res = farm.run(**kwargs, verbose=False)
    _sync(dev)
    kind = "replays" if graph_counts["replays"] else "uncaptured"
    per_iter = graph_counts[kind + "_s"] / max(graph_counts[kind], 1)
    return dict(seeds=res.seeds, logs=[log._asdict() for log in res.trial_logs],
                params=_np(res.policy_params), local_seeds=list(farm.local_seeds),
                seed_steps_per_s=len(farm.local_seeds) / per_iter if per_iter else None,
                launches=dict(fp.launches))


def join_farms(parts: list) -> dict:
    """:func:`run_farm` results of consecutive groups of seeds (one process
    each), joined in seed order as a seed-sharded farm gathers them;
    ``seed_steps_per_s`` is the groups' mean."""
    cat = np.concatenate
    return dict(seeds=cat([p["seeds"] for p in parts]),
                logs=[{k: cat([p["logs"][t][k] for p in parts]) for k in parts[0]["logs"][t]
                       if k != "wall_clock_s"} for t in range(len(parts[0]["logs"]))],
                params={k: cat([p["params"][k] for p in parts]) for k in parts[0]["params"]},
                seed_steps_per_s=float(np.mean([p["seed_steps_per_s"] for p in parts])))


def run_restarts(spec: dict, mesh=None) -> dict:
    """Check 4: ``optimize`` with ``restarts`` lanes from the spec's inputs
    (the posterior of its GP parameters over its data), the lanes over the
    restart x particle ``mesh`` or in one process.  ``spec['lane_batch']``
    (one process only): the lanes run in batches of that many, as each rank
    of a mesh with restarts / lane_batch restart shards runs them, and the
    winner is picked over all of them as ``optimize`` picks it."""
    dev = torch.device(spec.get("device", "cuda")) if mesh is None else mesh.device
    s = _to(spec, dev)
    opt = dataclasses.replace(s["optimizer"], mesh=mesh, num_restarts=s["restarts"])
    post = opt.engine.gp.fit_posterior(s["gp_params"], s["data"])
    fp.reset_launches()
    args = (s["gp_params"], post, s["steps"], s["lr0"], s["p_dropout0"])
    k = spec.get("lane_batch")
    if mesh is None and k:
        R = s["restarts"]
        inits = opt.restart_inits(s["key"], s["policy_params"], R)
        results, metric = [], []
        for r0 in range(0, R, k):
            params = {n: torch.stack([p[n] for p in inits[r0:r0 + k]]) for n in inits[0]}
            res, m = opt.optimize_lanes([s["key"]] * k, params, *args,
                                        rids=list(range(r0, r0 + k)), chunk=s.get("chunk"))
            results += res
            metric.append(m)
        metric = np.concatenate(metric)
        winner = int(np.argmin(np.where(np.isfinite(metric), metric, np.inf)))
        res = results[winner]._replace(restart_costs=metric, restart_winner=winner)
    else:
        res = opt.optimize(s["key"], s["policy_params"], *args, chunk=s.get("chunk"))
    _sync(dev)
    return dict(_opt_out(res), launches=dict(fp.launches))


def mesh_shapes(n: int) -> tuple:
    """The 2D meshes of the checks on n ranks: (seed groups or restart
    shards, particle shards), the particle axis 2 wide where n allows."""
    return (max(n // 2, 1), min(n, 2))


def _round_check(name, spec, n, say):
    mesh = mesh_mod.make_mesh(n)
    r = run_round(spec, mesh)
    c, steps = r["cost_history"], r["steps_done"]
    _finite(c[:steps], "rollout costs")
    _finite(r["mll_history"], "GP MLL")
    P = spec["optimizer"].num_particles
    say(f"[dryrun] {n}-rank particle mesh OK: {steps} sharded opt steps ({P} particles over "
        f"{n} ranks, {P // n} each, {mesh.device.type}), cost {c[0]:.3f} -> "
        f"{c[steps - 1]:.3f}, mll {r['mll_history'][0]:.1f} -> {r['mll_history'][-1]:.1f}, "
        f"gathered states {tuple(r['states'].shape)}")
    return r


def _farm_check(name, spec, n, say):
    mesh = mesh_mod.make_mesh(n)
    f = run_farm(spec, mesh)
    log = f["logs"][-1]
    _finite(log["control_true"], "farm states")
    say(f"[dryrun] seed farm OK: {len(f['seeds'])} seeds over {n} seed groups, opt steps "
        f"{log['steps_done'].tolist()}, final costs med "
        f"{float(np.median(log['cost_history'].max(axis=1))):.2f}")
    return f


def _farm2d_check(name, spec, n, say):
    a, b = spec.get("mesh") or mesh_shapes(n)
    mesh = mesh_mod.make_seed_particle_mesh(a, b)
    f = run_farm(spec, mesh, two_d=True)
    log = f["logs"][-1]
    _finite(log["control_true"], "2D-mesh farm states")
    say(f"[dryrun] 2D seed x particle mesh OK: {a} seed groups x {b} particle shards, opt "
        f"steps {log['steps_done'].tolist()}, final costs med "
        f"{float(np.median(log['cost_history'].max(axis=1))):.2f}")
    return f


def _restart_check(name, spec, n, say):
    a, b = spec.get("mesh") or mesh_shapes(n)
    mesh = mesh_mod.make_restart_particle_mesh(a, b)
    r = run_restarts(spec, mesh)
    _finite(r["restart_costs"], "restart lane costs")
    say(f"[dryrun] restart x particle mesh OK: {spec['restarts']} restart lanes over {a} "
        f"restart shards x {b} particle shards, winner lane {r['restart_winner']}, lane costs "
        f"{[round(float(v), 2) for v in r['restart_costs']]}")
    return r


def _errors_check(name, spec, n, say):
    """The refusals of a mesh that does not fit (the JAX package's
    ``ValueError``s of ``control/trainer.py:303-319`` and
    ``parallel/multiseed.py:127-157``) and of ranks whose device bodies ran
    unequally often: {case: (exception name, message) or None}."""
    import torch.distributed as dist

    a, b = mesh_shapes(n)
    rmesh = mesh_mod.make_restart_particle_mesh(a, b)
    pmesh = mesh_mod.make_mesh(n)
    cfg = spec["farm"]["cfg"]
    dev = pmesh.device
    st = tiny_setup(4 * n, device=dev)

    def restarts(R, vmap=True):
        opt = dataclasses.replace(st.optimizer, mesh=rmesh, num_restarts=R, restart_vmap=vmap)
        opt.optimize(st.key, st.policy_params, st.gp_params, st.posterior, 1, 0.01, 0.0)

    def farm(seeds, optimizer_mesh):
        agent, _ = cartpole.build(cfg, dev, mesh=optimizer_mesh)
        SeedFarm(agent, seeds, mesh=pmesh)

    cases = {
        "restart axis, one restart": lambda: restarts(1),
        "restarts do not tile": lambda: restarts(a + 1),
        "sequential restart lanes": lambda: restarts(2 * a, vmap=False),
        "farm over an optimizer's particle mesh": lambda: farm(list(range(1, n + 1)), pmesh),
        "seeds do not tile": lambda: farm(list(range(1, n + 2)), None),
        "unequal device-body runs": lambda: dataclasses.replace(
            st.optimizer, mesh=pmesh)._agree(25, dist.get_rank()),
    }
    out = {}
    for case, fn in cases.items():
        try:
            fn()
            out[case] = None
        except (ValueError, RuntimeError) as err:
            out[case] = (type(err).__name__, str(err))
    return out


def _cost_check(name, spec, n, say):
    """``expected_cost`` of this rank's particles of ``spec['stage']`` [T, L,
    P] over the particle group: (cost [L], std [L], d(sum cost)/d(stage) of
    this rank's particles)."""
    from ..models.costs import expected_cost

    mesh = mesh_mod.make_mesh(n)
    local = mesh_mod.shard_particles(mesh, torch.as_tensor(spec["stage"]), dim=2)
    local = local.clone().requires_grad_(True)
    cost, std = expected_cost(local, mesh.group(mesh_mod.PARTICLE_AXIS))
    (grad,) = torch.autograd.grad(cost.sum(), [local])
    return dict(cost=_np(cost), std=_np(std), grad=_np(grad))


def _step_check(name, spec, n, say):
    """One ``make_sharded_train_step`` step from the spec's inputs on a
    particle mesh of every rank."""
    from .shard import adam_init, make_sharded_train_step

    mesh = mesh_mod.make_mesh(n)
    s = _to(spec, mesh.device)
    step = make_sharded_train_step(s["optimizer"], mesh)
    post = s["optimizer"].engine.gp.fit_posterior(s["gp_params"], s["data"])
    out = step(s["policy_params"], adam_init(s["policy_params"]), s["gp_params"],
               adam_init(s["gp_params"]), s["data"], post, s["key"], 0.01, 0.0)
    return dict(cost=_np(out.cost), mll=_np(out.mll), params=_np(out.policy_params),
                gp_params=_np(out.gp_params))


CHECKS = {"round": _round_check, "farm": _farm_check, "farm2d": _farm2d_check,
          "restart": _restart_check, "errors": _errors_check, "cost": _cost_check,
          "step": _step_check}


def worker(spec: dict, verbose=True) -> dict:
    """Every rank's part of the checks of ``spec`` (name -> inputs, the kind
    of check under "kind", default the name; see :func:`tiny_spec`), in
    order; rank 0 prints one line per check.  Returns {name: results}."""
    import torch.distributed as dist

    from .. import disable_tf32

    disable_tf32()
    n = dist.get_world_size()
    quiet = not verbose or dist.get_rank() != 0
    say = (lambda msg: None) if quiet else (lambda msg: print(msg, flush=True))
    out = {}
    for name, s in spec.items():
        t0 = time.perf_counter()
        out[name] = CHECKS[s.get("kind", name)](name, s, n, say)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def reference(spec: dict) -> dict:
    """The round, farm and restart checks of ``spec`` without a mesh, in
    this process, on ``spec[name]['device']`` (default the card): what the
    ranks are held against."""
    run = {"round": run_round, "farm": run_farm, "restart": run_restarts}
    return {name: run[s.get("kind", name)](s) for name, s in spec.items()
            if s.get("kind", name) in run}


def _finite(a, what):
    if not np.all(np.isfinite(np.asarray(a))):
        raise RuntimeError(f"non-finite {what}: {a}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: one card per rank over NCCL; cpu: gloo")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    mesh_mod.launch(worker, args.ranks, args.device, args=(tiny_spec(args.device),))
    print(f"[dryrun] {args.ranks} ranks ({args.device}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
