"""Shared setup of the JAX-vs-port rollout and slice tests.

``Problem`` builds the flagship's model, SE+P(2) GP, policy and cost in both
packages at a small size, or with ``pms=True`` the 4PMS cart-pole's (30 Hz,
SE GP, the sensor chain in the rollout, BPTT clip 0.2); ``collect_data``
makes training data with the port's plant on the CPU.
``assert_same_config`` compares two packages' config objects field by field.
``jax_rollout_noise`` reproduces, in the test, the random draws that
``mcpilco_tpu``'s rollout and trainer make from a key
(``control/rollout.py:213-229,275-276``, ``control/trainer.py:248-251``),
so that the port can be handed the same numbers.
"""

import dataclasses
import math

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
from mcpilco_tpu_torch.envs.plants import ODEPlant, PMSODEPlant, offline_velocity_estimation
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
PMS_DT = 1.0 / 30.0
# fc=0.3, not the scenario's 0.5: butter(1, 0.5) has a1 = 0, which would
# leave the online filter's feedback term untested
SENSORS = dict(pos_indices=(0, 2), vel_indices=(1, 3), std_pos_noise=(3e-3, 3e-3), fc=0.3,
               dt=PMS_DT)
SINUSOIDS = dict(state_dim=4, input_dim=1, num_sin=10, omega_min=0.1 * 2 * np.pi,
                 omega_max=2 * 2 * np.pi, amplitude_min=1.0, amplitude_max=1.0, dt=PMS_DT)


def policy_kwargs(num_basis):
    return dict(feature_dim=5, input_dim=1, num_basis=num_basis, u_max=10.0, angle_indices=(2,),
                non_angle_indices=(0, 1, 3), reinit_lengthscales=(1.0,) * 5,
                reinit_centers=(np.pi, np.pi, np.pi, 1.0, 1.0), reinit_weight=10.0)


def collect_data(num_trials=1, T=3.0, seed=0, pms=False):
    """(x [N, 6], y [2, N]) from cart-pole trials on the port's plant, as
    numpy float32: random inputs at 20 Hz, or with ``pms=True`` the 4PMS
    protocol (sinusoid inputs at 30 Hz, offline velocity estimation)."""
    if pms:
        plant = PMSODEPlant(ode_name="cartpole", noise_std=(3e-3,) * 4, **{
            k: SENSORS[k] for k in ("pos_indices", "vel_indices", "fc")})
        expl = tpol.SumOfSinusoids(**SINUSOIDS)
        params, dt = expl.init_params(tprng.root_key(seed)), PMS_DT
    else:
        plant = ODEPlant(ode_name="cartpole", noise_std=(1e-2,) * 4)
        expl = tpol.RandomExploration(state_dim=4, input_dim=1, u_max=10.0)
        params, dt = {}, 0.05
    model = tdyn.SpeedIntegration(**dict(MODEL, dt=dt))
    xs, ys = [], []
    for i in range(num_trials):
        trial = plant.rollout(tprng.fold(tprng.root_key(seed), i), np.zeros(4), expl, params, T,
                              dt, device="cpu")
        states, inputs = trial.measured, trial.inputs
        if pms:
            states, inputs = offline_velocity_estimation(trial.noisy, inputs, dt, (0, 2), (1, 3))
        x, y = model.training_pairs(torch.as_tensor(states, dtype=torch.float32),
                                    torch.as_tensor(inputs))
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
    """The flagship's pieces, or with ``pms=True`` the 4PMS cart-pole's, in
    both packages (``j*`` JAX, ``t*`` port)."""

    def __init__(self, num_basis=20, pms=False):
        if pms:
            jk, tk = jK.SEArd(tuple(range(6))), tK.SEArd(tuple(range(6)))
            model = dict(MODEL, dt=PMS_DT)
            engine = dict(bptt_clip=0.2)
            jengine = dict(engine, sensors=jroll.PMSSensors(**SENSORS))
            tengine = dict(engine, sensors=troll.PMSSensors(**SENSORS))
        else:
            jk = jK.se_plus_volterra(tuple(range(6)), 2)
            tk = tK.se_plus_volterra(tuple(range(6)), 2)
            model, jengine, tengine = MODEL, {}, {}
        self.jmodel, self.tmodel = jdyn.SpeedIntegration(**model), tdyn.SpeedIntegration(**model)
        self.jgp, self.tgp = jgp.MultiGP(kernel=jk, num_heads=2), tgp.MultiGP(kernel=tk, num_heads=2)
        self.jpolicy = jpol.SumOfGaussiansWithAngles(**policy_kwargs(num_basis))
        self.tpolicy = tpol.SumOfGaussiansWithAngles(**policy_kwargs(num_basis))
        self.jcost, self.tcost = jcosts.CartPoleCost(**COST), tcosts.CartPoleCost(**COST)
        self.jinit = jroll.InitialStateDistribution(**INIT)
        self.tinit = troll.InitialStateDistribution(**INIT)
        self.jengine = jroll.RolloutEngine(model=self.jmodel, gp=self.jgp, policy=self.jpolicy,
                                           **jengine)
        self.tengine = troll.RolloutEngine(model=self.tmodel, gp=self.tgp, policy=self.tpolicy,
                                           **tengine)

    def policy_params(self, seed=1, dtype=jnp.float32):
        """JAX policy params with centers spread over the state range."""
        p = self.jpolicy.init_params(jax.random.PRNGKey(seed), dtype=dtype)
        return dict(p, centers=p["centers"] * jnp.asarray([3.0, 3.0, 3.0, 1.0, 1.0], dtype))


def jax_rollout_noise(key, P, T, G, num_basis, p_dropout, init_dim=None, n_pos=None,
                      dtype=jnp.float32, keep_uniforms=False):
    """The draws of one JAX rollout from ``key``, as a port RolloutNoise;
    ``n_pos`` adds the sensor chain's position-noise draws; with
    ``keep_uniforms`` ``keep`` holds the uniforms under the dropout masks
    (``jax.random.bernoulli(k, q, shape)`` is ``uniform(k, shape) < q``),
    which give the mask at any rate."""

    def normals(tag, width):
        return torch.as_tensor(np.stack([
            np.asarray(jax.random.normal(jprng.stream(jprng.fold(key, t), tag), (P, width), dtype))
            for t in range(1, T)
        ]))

    keep = None
    if keep_uniforms:
        keep = torch.as_tensor(np.stack([
            np.asarray(jax.random.uniform(
                jprng.stream(jprng.fold(key, t), jprng.STREAM_DROPOUT), (P, num_basis)))
            for t in range(T)
        ]))
    elif p_dropout > 0:
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
    meas = None if n_pos is None else normals(jprng.STREAM_MEAS_NOISE, n_pos)
    return troll.RolloutNoise(state=normals(jprng.STREAM_ROLLOUT, G), keep=keep, init=init,
                              meas=meas)


# dataclass fields only the JAX package has (its scan unroll, Pallas switch
# and NaN-branch lowering)
JAX_ONLY_FIELDS = {"scan_unroll", "nan_branch_style", "use_pallas"}


def assert_same_config(j, t, path="agent"):
    """A JAX config object ``j`` and the port's ``t``: dataclass fields by
    name, recursively (the port may lack only ``JAX_ONLY_FIELDS``), values
    equal (floats within 1e-12 relative)."""
    if dataclasses.is_dataclass(j) and not isinstance(j, type):
        assert type(j).__name__ == type(t).__name__, path
        names = [f.name for f in dataclasses.fields(j)]
        port = {f.name for f in dataclasses.fields(t)}
        assert set(names) - port <= JAX_ONLY_FIELDS, (path, set(names) - port)
        assert port <= set(names), (path, port - set(names))
        for n in names:
            if n in port:
                assert_same_config(getattr(j, n), getattr(t, n), f"{path}.{n}")
    elif isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)) and len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same_config(a, b, f"{path}[{i}]")
    elif isinstance(j, float) and isinstance(t, float):
        assert math.isclose(j, t, rel_tol=1e-12, abs_tol=1e-300), (path, j, t)
    else:
        assert j == t, (path, j, t)
