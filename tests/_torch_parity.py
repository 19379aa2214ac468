"""Shared setup of the JAX-vs-port rollout and slice tests.

``Problem`` builds the flagship's model, SE+P(2) GP, policy and cost in both
packages at a small size; ``collect_data`` makes training data with the
port's plant on the CPU.  ``jax_rollout_noise`` reproduces, in the test, the random draws
that ``mcpilco_tpu``'s rollout and trainer make from a key
(``control/rollout.py:213-229``, ``control/trainer.py:248-251``), so that
the port can be handed the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mcpilco_tpu.control import rollout as jroll
from mcpilco_tpu.models import costs as jcosts
from mcpilco_tpu.models import dynamics as jdyn
from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import kernels as jK
from mcpilco_tpu.models import policies as jpol
from mcpilco_tpu.utils import prng as jprng
from mcpilco_tpu_torch.control import rollout as troll
from mcpilco_tpu_torch.envs.plants import ODEPlant
from mcpilco_tpu_torch.models import costs as tcosts
from mcpilco_tpu_torch.models import dynamics as tdyn
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models import policies as tpol
from mcpilco_tpu_torch.utils import prng as tprng

MODEL = dict(state_dim=4, input_dim=1, dt=0.05, vel_indices=(1, 3), pos_indices=(0, 2),
             angle_indices=(2,), not_angle_indices=(0, 1, 3))
COST = dict(target_state=(np.pi, 0.0), lengthscales=(3.0, 1.0), angle_index=2, pos_index=0)
INIT = dict(kind="gaussian", mean=np.zeros(4), var=1e-4 * np.ones(4))


def policy_kwargs(num_basis):
    return dict(feature_dim=5, input_dim=1, num_basis=num_basis, u_max=10.0, angle_indices=(2,),
                non_angle_indices=(0, 1, 3), reinit_lengthscales=(1.0,) * 5,
                reinit_centers=(np.pi, np.pi, np.pi, 1.0, 1.0), reinit_weight=10.0)


def collect_data(num_trials=1, T=3.0, seed=0):
    """(x [N, 6], y [2, N]) from random-input cart-pole trials on the port's
    plant, as numpy float32."""
    plant = ODEPlant(ode_name="cartpole", noise_std=(1e-2,) * 4)
    expl = tpol.RandomExploration(state_dim=4, input_dim=1, u_max=10.0)
    model = tdyn.SpeedIntegration(**MODEL)
    xs, ys = [], []
    for i in range(num_trials):
        trial = plant.rollout(tprng.fold(tprng.root_key(seed), i), np.zeros(4), expl, {}, T, 0.05)
        x, y = model.training_pairs(torch.as_tensor(trial.measured), torch.as_tensor(trial.inputs))
        xs.append(x.numpy())
        ys.append(y.numpy())
    return np.concatenate(xs), np.concatenate(ys, axis=1)


def padded(x, y, cap):
    n = x.shape[0]
    xp = np.zeros((cap, x.shape[1]), x.dtype)
    yp = np.zeros((y.shape[0], cap), y.dtype)
    xp[:n], yp[:, :n] = x, y
    mask = np.zeros(cap, x.dtype)
    mask[:n] = 1.0
    return xp, yp, mask


class Problem:
    """The flagship pieces in both packages (``j*`` JAX, ``t*`` port)."""

    def __init__(self, num_basis=20):
        jk, tk = jK.se_plus_volterra(tuple(range(6)), 2), tK.se_plus_volterra(tuple(range(6)), 2)
        self.jmodel, self.tmodel = jdyn.SpeedIntegration(**MODEL), tdyn.SpeedIntegration(**MODEL)
        self.jgp, self.tgp = jgp.MultiGP(kernel=jk, num_heads=2), tgp.MultiGP(kernel=tk, num_heads=2)
        self.jpolicy = jpol.SumOfGaussiansWithAngles(**policy_kwargs(num_basis))
        self.tpolicy = tpol.SumOfGaussiansWithAngles(**policy_kwargs(num_basis))
        self.jcost, self.tcost = jcosts.CartPoleCost(**COST), tcosts.CartPoleCost(**COST)
        self.jinit = jroll.InitialStateDistribution(**INIT)
        self.tinit = troll.InitialStateDistribution(**INIT)
        self.jengine = jroll.RolloutEngine(model=self.jmodel, gp=self.jgp, policy=self.jpolicy)
        self.tengine = troll.RolloutEngine(model=self.tmodel, gp=self.tgp, policy=self.tpolicy)

    def policy_params(self, seed=1, dtype=jnp.float32):
        """JAX policy params with centers spread over the state range."""
        p = self.jpolicy.init_params(jax.random.PRNGKey(seed), dtype=dtype)
        return dict(p, centers=p["centers"] * jnp.asarray([3.0, 3.0, 3.0, 1.0, 1.0], dtype))


def jax_rollout_noise(key, P, T, G, num_basis, p_dropout, init_dim=None, dtype=jnp.float32):
    """The draws of one JAX rollout from ``key``, as a port RolloutNoise."""
    state = [jax.random.normal(jprng.stream(jprng.fold(key, t), jprng.STREAM_ROLLOUT), (P, G), dtype)
             for t in range(1, T)]
    keep = None
    if p_dropout > 0:
        p = jnp.asarray(p_dropout, dtype)
        keep = torch.as_tensor(np.stack([
            np.asarray(jax.random.bernoulli(
                jprng.stream(jprng.fold(key, t), jprng.STREAM_DROPOUT),
                jnp.maximum(1.0 - p, 1e-6), (P, num_basis)))
            for t in range(T)
        ]))
    init = None
    if init_dim is not None:
        init = torch.tensor(np.asarray(jax.random.normal(
            jprng.stream(key, jprng.STREAM_INIT_PARTICLES), (P, init_dim), dtype)))
    return troll.RolloutNoise(state=torch.as_tensor(np.stack([np.asarray(s) for s in state])),
                              keep=keep, init=init)
