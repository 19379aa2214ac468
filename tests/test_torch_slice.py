"""The flagship slice as a whole: the port against the JAX package, the
port's smoke config end to end, and the port's independence from jax.

(a) At a small size (P=16, horizon 10, 20 basis, SE+P(2), N=60 in a 64
    bucket), with data from the port's plant, GP hyperparameters fitted by
    JAX and the JAX posterior carried across with ``utils/convert.py``: one
    ``_rollout_cost`` value and policy gradient, and the policy after 3
    optimizer steps, with the JAX draws injected.  float32 throughout, as in
    production.  Cost and gradient: rtol 1e-3 (BPTT through 10 closed-loop
    steps compounds two frameworks' float32 rounding).  Params after Adam:
    atol 1e-5 -- each Adam step moves a leaf by ~lr * sign(grad), which a
    1e-3 relative gradient difference barely changes.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import Problem, collect_data, jax_rollout_noise, padded
from mcpilco_tpu.control import trainer as jtrainer
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.utils import prng as jprng
from mcpilco_tpu_torch.control import trainer as ttrainer
from mcpilco_tpu_torch.control.rollout import stack_lanes
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.scenarios import cartpole as tcart
from mcpilco_tpu_torch.utils import prng as tprng
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

P, T, NB = 16, 10, 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_small_slice_matches_jax():
    prob = Problem(num_basis=NB)
    x, y, mask = padded(*collect_data(), 64)
    data = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    params, _ = jax.jit(lambda p, d: prob.jgp.fit(p, d, num_epochs=100, learning_rate=0.05))(
        prob.jgp.init_params(), data)
    post = jax.jit(prob.jgp.fit_posterior)(params, data)
    pol = prob.policy_params()
    kw = dict(engine=None, cost=None, init_dist=None, num_particles=P, horizon=T,
              max_opt_steps=5, min_diff_cost=0.08, num_min_diff_cost=20, min_step=10.0,
              lr_min=0.0025, p_drop_reduction=0.125)
    jopt = jtrainer.PolicyOptimizer(**dict(kw, engine=prob.jengine, cost=prob.jcost,
                                           init_dist=prob.jinit))
    topt = ttrainer.PolicyOptimizer(**dict(kw, engine=prob.tengine, cost=prob.tcost,
                                           init_dist=prob.tinit))
    t_gp = to_torch(_np(params), "cpu", into=tgp.GPParams)
    t_post = to_torch(_np(post), "cpu", into=tgp.Posterior)
    t_pol = to_torch(_np(pol), "cpu")
    p_drop = 0.25

    # one rollout cost and its policy gradient
    key = jax.random.PRNGKey(11)
    (cj, _), gj = jax.jit(jax.value_and_grad(jopt._rollout_cost, has_aux=True))(
        pol, params, post, key, jnp.float32(p_drop), 0)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t_pol.items()}
    noise = jax_rollout_noise(key, P, T, 2, NB, p_drop, init_dim=4)
    lanes = {k: v[None] for k, v in leaves.items()}  # one lane
    ct, _ = topt._rollout_cost(lanes, t_gp, t_post, [tprng.root_key(11)], p_drop, 0,
                               stack_lanes([noise]))
    ct = ct[0]
    gt = torch.autograd.grad(ct, list(leaves.values()))
    np.testing.assert_allclose(ct.item(), float(cj), rtol=1e-3)
    for name, g in zip(leaves, gt):
        scale = float(np.abs(np.asarray(gj[name])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]), rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=name)

    # three optimizer steps; the port's step keys carry the same counters as
    # the JAX ones, so each step's draws are folded from the JAX key
    jkey, tkey = jax.random.PRNGKey(5), tprng.root_key(5)

    def noise_fn(k):
        return jax_rollout_noise(jprng.fold(jkey, *k[len(tkey):]), P, T, 2, NB, p_drop,
                                 init_dim=4)

    jres = jopt.optimize(jkey, pol, params, post, 3, 0.01, p_drop)
    tres = topt.optimize(tkey, t_pol, t_gp, t_post, 3, 0.01, p_drop, noise_fn=noise_fn)
    assert tres.steps_done == int(jres.steps_done) == 3
    np.testing.assert_allclose(tres.cost_history.numpy(), np.asarray(jres.cost_history),
                               rtol=1e-3)
    for name, v in tres.policy_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jres.policy_params[name]), atol=1e-5,
                                   err_msg=name)
    assert tres.reinit_count == int(jres.reinit_count) == 0


def test_smoke_config_trains_end_to_end_on_cpu():
    agent, kwargs = tcart.build(tcart.CartpoleConfig(seed=3).smoke(), "cpu")
    logs = agent.reinforce(**kwargs, verbose=False)
    assert len(logs) == 1 and logs[0].steps_done > 0
    assert np.all(np.isfinite(logs[0].cost_history))
    assert len(agent.trials) == 2  # exploration + the controlled trial
    assert np.all(np.isfinite(agent.trials[-1].true))
    assert agent.posterior.x_tr.shape[0] == 64


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import mcpilco_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(mcpilco_tpu_torch.__path__,
                                                       "mcpilco_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert not any(m == "jax" or m.startswith(("jax.", "mcpilco_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the slice was imported
