"""The inputs of one run, made from ``--seed`` and handed alike to the port
and to the plain reference: each lane's training trials (plant states
integrated by the configuration's ODE, a frozen copy kept in its reference
module and named by its ``data["ode"]`` key, under random
exploration inputs, with measurement noise), its GP hyperparameters and its
initial policy.  Everything is drawn on the host in numpy float64 from
``numpy.random.SeedSequence([seed, lane, tag])``, so one seed gives the
same inputs on every machine; the tensors go to the device once.
"""

from __future__ import annotations

import importlib
import math

import numpy as np

TAG_DATA, TAG_GP, TAG_POLICY = 0xD1, 0xD2, 0xD3


def rng(seed: int, lane: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 63), lane, tag]))


def reference_module(cfg: dict):
    """The configuration's own module of the plain reference, named by its
    ``reference`` key: its plant's ODE, its model's functions and its FLOP
    count live there, so that a configuration is new files only."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def trials(spec: dict, ode, gen: np.random.Generator):
    """``spec["trials"]`` trials of ``spec["steps"]`` steps of the plant
    ``ode(x, u) -> dx/dt`` (numpy, batched over the first axis), integrated
    together by RK4 (``substeps`` per step, the input held): random
    exploration inputs u_max tanh(U(-1, 1)) each step, initial states
    N(x0_mean, x0_std^2), measured with N(0, noise_std^2) noise.  Returns
    (measured [trials, steps + 1, ds], inputs [trials, steps + 1, du]),
    float32."""
    n, steps, ds = spec["trials"], spec["steps"], len(spec["x0_mean"])
    u_max, h = spec["u_max"], spec["dt"] / spec["substeps"]
    x = np.asarray(spec["x0_mean"]) + np.asarray(spec["x0_std"]) * gen.standard_normal((n, ds))
    u = u_max * np.tanh(gen.uniform(-1.0, 1.0, (n, steps + 1, 1)))
    noise = spec["noise_std"] * gen.standard_normal((n, steps + 1, ds))
    states = [x]
    for t in range(steps):
        for _ in range(spec["substeps"]):
            k1 = ode(x, u[:, t])
            k2 = ode(x + 0.5 * h * k1, u[:, t])
            k3 = ode(x + 0.5 * h * k2, u[:, t])
            k4 = ode(x + h * k3, u[:, t])
            x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        states.append(x)
    measured = np.stack(states, axis=1) + noise
    return measured.astype(np.float32), u.astype(np.float32)


# -------------------------------------------------------------- parameters


def _leaf(spec: dict, heads: int, gen: np.random.Generator):
    """A leaf [heads, *shape]: ``center`` (a number or one per entry) plus
    ``spread`` standard normals."""
    shape = (heads, *spec["shape"])
    center = np.broadcast_to(np.asarray(spec["center"], np.float64), shape)
    return (center + spec["spread"] * gen.standard_normal(shape)).astype(np.float32)


def gp_params(spec: dict, heads: int, gen: np.random.Generator):
    """(kernel tree, log_sigma_n [heads]): the kernel a dict of leaves, or a
    tuple of them (one per member of a Sum), each with the head axis."""
    members = [{k: _leaf(v, heads, gen) for k, v in m.items()} for m in spec["members"]]
    kernel = members[0] if spec.get("single") else tuple(members)
    return kernel, _leaf(spec["log_sigma_n"], heads, gen)


def policy_params(spec: dict, gen: np.random.Generator) -> dict:
    """An RBF policy: unit lengthscales, centers U(low, high) per feature
    (``angle_pairs`` [i, j] make features i, j the cos and sin of one
    U(-pi, pi) angle), weights ``weight_scale`` (U(0, 1) - 0.5)."""
    nb, nf = spec["num_basis"], len(spec["center_low"])
    lo, hi = np.asarray(spec["center_low"]), np.asarray(spec["center_high"])
    centers = lo + (hi - lo) * gen.uniform(0.0, 1.0, (nb, nf))
    for i, j in spec.get("angle_pairs", []):
        a = gen.uniform(-math.pi, math.pi, nb)
        centers[:, i], centers[:, j] = np.cos(a), np.sin(a)
    weight = spec["weight_scale"] * (gen.uniform(0.0, 1.0, (1, nb)) - 0.5)
    return {"log_lengthscales": np.zeros(nf, np.float32), "centers": centers.astype(np.float32),
            "weight": weight.astype(np.float32)}


def lane_inputs(cfg: dict, seed: int, lane: int) -> dict:
    """One lane's inputs: measured states, inputs, GP hyperparameters and the
    initial policy."""
    ode = getattr(reference_module(cfg), cfg["data"]["ode"])
    measured, inputs = trials(cfg["data"], ode, rng(seed, lane, TAG_DATA))
    kernel, log_sigma_n = gp_params(cfg["gp_params"], cfg["num_heads"], rng(seed, lane, TAG_GP))
    return dict(measured=measured, inputs=inputs, kernel=kernel, log_sigma_n=log_sigma_n,
                policy=policy_params(cfg["policy"], rng(seed, lane, TAG_POLICY)))
