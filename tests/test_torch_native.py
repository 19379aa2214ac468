"""The port's native RK45 (``mcpilco_tpu_torch.native``): the cases of
``tests/test_native.py`` on the port's copy, its build directory, and both
packages' ``integrate`` on the same inputs.

Both packages compile the same C++ source with the same flags, so their
results agree within 1e-12 (in practice bitwise).  Against scipy's LSODA the
tolerance is the JAX test's (rtol 1e-6, atol 1e-8); against the RK4 of
``envs/ode.py`` (float32, 20 sub-steps) rtol 1e-4, atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from mcpilco_tpu import native as jnative
from mcpilco_tpu_torch import native
from mcpilco_tpu_torch.envs import ode as ode_mod

torch.set_num_threads(1)


class TestNativeRK45:
    def test_cartpole_matches_scipy_lsoda(self):
        scipy_int = pytest.importorskip("scipy.integrate")
        x0 = np.array([0.1, -0.3, 0.5, 1.2])
        u = np.array([2.0])

        def np_cartpole(y, t, uu):
            # float64 dynamics: the float32 tensor version would cap the
            # reference's accuracy at ~1e-7 per call
            m1, m2, l, b, g = 0.5, 0.5, 0.5, 0.1, 9.81
            xd, th, thd = y[1], y[2], y[3]
            sn, cs = np.sin(th), np.cos(th)
            den = 4 * (m1 + m2) - 3 * m2 * cs * cs
            return np.array([
                xd,
                (2 * m2 * l * thd**2 * sn + 3 * m2 * g * sn * cs + 4 * uu - 4 * b * xd) / den,
                thd,
                (-3 * m2 * l * thd**2 * sn * cs - 6 * (m1 + m2) * g * sn
                 - 6 * (uu - b * xd) * cs) / (l * den),
            ])

        x_ref = scipy_int.odeint(
            np_cartpole, x0, [0.0, 0.05], args=(2.0,), rtol=1e-10, atol=1e-12
        )[1]
        x_nat = native.integrate("cartpole", x0, 0.0, 0.05, u)
        np.testing.assert_allclose(x_nat, x_ref, rtol=1e-6, atol=1e-8)
        # the caller's buffer is not changed
        np.testing.assert_array_equal(x0, [0.1, -0.3, 0.5, 1.2])

    def test_pendulum_energy_decay(self):
        # the unforced pendulum with friction loses energy
        x = np.array([2.0, 0.0])
        u = np.array([0.0])

        def energy(s):
            m, l, g = 1.0, 1.0, 9.81
            inertia = m * l * l / 3.0
            return 0.5 * inertia * s[1] ** 2 - 0.5 * m * l * g * np.cos(s[0])

        e0 = energy(x)
        for _ in range(100):
            x = native.integrate("pendulum", x, 0.0, 0.05, u)
        assert energy(x) < e0

    def test_matches_torch_rk4(self):
        x0 = np.array([0.0, 0.0, 0.1, 0.0])
        u = np.array([1.0])
        x_nat = native.integrate("cartpole", x0, 0.0, 0.05, u)
        x_rk4 = ode_mod.integrate(ode_mod.cartpole, torch.tensor(x0, dtype=torch.float32),
                                  torch.tensor(u, dtype=torch.float32), 0.05, 20).numpy()
        np.testing.assert_allclose(x_nat, x_rk4, rtol=1e-4, atol=1e-6)

    def test_furuta_runs(self):
        x = native.integrate("furuta", np.array([0.0, 0.1, 0.0, 0.0]), 0.0, 0.02, np.array([0.01]))
        assert np.isfinite(x).all()

    def test_unknown_system_raises(self):
        with pytest.raises(KeyError):
            native.integrate("nonexistent", np.zeros(2), 0.0, 0.1, np.zeros(1))

    def test_long_interval_stable(self):
        # one long adaptive interval instead of many short ones
        x = native.integrate("cartpole", np.zeros(4), 0.0, 5.0, np.array([3.0]))
        assert np.isfinite(x).all()


@pytest.mark.parametrize("system,x0,u,t1", [
    ("pendulum", [2.0, -0.4], [0.3], 0.05),
    ("cartpole", [0.1, -0.3, 0.5, 1.2], [2.0], 0.05),
    ("cartpole", [0.0, 0.0, 3.0, 0.0], [-5.0], 2.0),
    ("furuta", [0.0, 0.1, 0.0, 0.0], [0.01], 0.02),
    ("furuta", [0.3, 3.0, -1.0, 2.0], [-0.05], 0.5),
])
def test_agrees_with_the_jax_package(system, x0, u, t1):
    """The same source, the same flags: the two libraries agree."""
    ours = native.integrate(system, np.array(x0), 0.0, t1, np.array(u))
    theirs = jnative.integrate(system, np.array(x0), 0.0, t1, np.array(u))
    np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=1e-12)
    assert native.SYSTEM_IDS == jnative.SYSTEM_IDS


def test_builds_into_the_build_dir_not_beside_the_source():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR
    assert lib.parent.name == "_build" and lib.parent.parent.name == "mcpilco_tpu_torch"
    src_dir = os.path.dirname(native.SOURCE)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    assert native.available()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """``load`` raises when the compiler refuses the source; ``available``
    only reports it."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.load()
    assert not native.available()
    assert not list((tmp_path / "_build").glob("*.so"))
