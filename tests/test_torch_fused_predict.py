"""The port's plain fused-predict functions and GramContract (CPU path)
against the JAX package's Pallas kernels (interpret mode) and plain-jnp twin.

The same numpy inputs go through both packages.  Tolerances are those of
tests/test_fused_predict.py: forward rtol 2e-5 / atol 1e-5 (float32 sums in a
different order), x* gradient rtol 1e-4 / atol 1e-4.  The input dims D run
over 6 (the cart-pole paths), 12 (the Furuta SE) and 24 (UR5's SE+P(2)):
above 8 the CUDA kernels walk the dims in chunks, and the plain twins they
are held against on the card are held here against the Pallas kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpilco_tpu.ops import fused_predict as jfp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models.gp import MultiGP, Posterior
from mcpilco_tpu_torch.ops import fused_predict as tfp

torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _inputs(G=2, P=50, M=64, D=6, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # inverse squared lengthscales scaled by 6 / D: the SE part stays O(0.1-1)
    # at every D instead of vanishing as exp(-2 D)
    return [
        np.exp(0.3 * f(G, D)) * np.float32(6.0 / D), np.exp(0.2 * f(G)),
        0.1 * np.exp(0.3 * f(G, D + 1)),
        0.1 * np.exp(0.3 * f(G, D)), 0.1 * np.exp(0.3 * f(G, D)), f(P, D), f(M, D), f(G, M),
        0.05 * f(G, M, M), (rng.uniform(size=(G, M)) > 0.2).astype(np.float32),
    ]


def _with_dims(values, dims=(6, 12, 24)):
    """(value, D) cases; D=6 keeps the case id it had before D was a parameter."""
    return [pytest.param(v, d, id=f"{v}" if d == 6 else f"{v}-D{d}")
            for d in dims for v in values]


def _cotangents(P, G=2):
    wk = np.linspace(0.5, 1.5, G * P, dtype=np.float32).reshape(G, P)
    wq = np.linspace(-1.0, 1.0, G * P, dtype=np.float32).reshape(G, P)
    return wk, wq


@pytest.mark.parametrize("use_poly", [False, True])
@pytest.mark.parametrize("P, D", _with_dims([37, 50]))
def test_forward_matches_pallas_and_jnp_twin(use_poly, P, D):
    args = _inputs(P=P, D=D, seed=P)
    ka_p, qd_p = jfp.gram_contract(*map(jnp.asarray, args), use_poly, True)
    ka_j, qd_j = jfp._reference_gram_contract(*map(jnp.asarray, args), use_poly)
    t_args = [torch.as_tensor(a) for a in args]
    ka_t, qd_t = tfp.reference_gram_contract(*t_args, use_poly)
    ka_g, qd_g = tfp.gram_contract(*t_args, use_poly)
    for ref in ((ka_p, qd_p), (ka_j, qd_j)):
        for port in ((ka_t, qd_t), (ka_g, qd_g)):
            np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), **FWD)
            np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]), **FWD)
    assert ka_t.shape == (2, P)


@pytest.mark.parametrize("use_poly", [False, True])
@pytest.mark.parametrize("P, D", _with_dims([37, 50]))
def test_xstar_gradient_matches_pallas_backward(use_poly, P, D):
    """x*'s cotangent through GramContract (CPU path) against the JAX
    custom_vjp, whose x* cotangent comes from the Pallas backward kernel."""
    args = _inputs(P=P, D=D, seed=100 + P)
    wk, wq = _cotangents(P)

    def loss_jax(xs):
        a = list(map(jnp.asarray, args))
        a[5] = xs
        ka, qd = jfp.gram_contract(*a, use_poly, True)
        return jnp.sum(wk * ka) + jnp.sum(wq * qd)

    g_jax = np.asarray(jax.jit(jax.grad(loss_jax))(jnp.asarray(args[5])))
    t_args = [torch.as_tensor(a) for a in args]
    xs = t_args[5].clone().requires_grad_(True)
    t_args[5] = xs
    ka, qd = tfp.gram_contract(*t_args, use_poly)
    loss = torch.sum(torch.as_tensor(wk) * ka) + torch.sum(torch.as_tensor(wq) * qd)
    (g_t,) = torch.autograd.grad(loss, xs)
    np.testing.assert_allclose(g_t.numpy(), g_jax, **GRAD)


def test_other_input_gradients_come_from_the_twin():
    """alpha's and F's cotangents, asked for explicitly, match JAX."""
    args = _inputs(P=12, M=32, seed=5)

    def loss_jax(alpha, f):
        a = list(map(jnp.asarray, args))
        a[7], a[8] = alpha, f
        ka, qd = jfp.gram_contract(*a, True, True)
        return jnp.sum(ka * qd)

    g_jax = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(jnp.asarray(args[7]),
                                                        jnp.asarray(args[8]))
    t_args = [torch.as_tensor(a) for a in args]
    t_args[7].requires_grad_(True)
    t_args[8].requires_grad_(True)
    ka, qd = tfp.gram_contract(*t_args, True)
    g_t = torch.autograd.grad(torch.sum(ka * qd), (t_args[7], t_args[8]))
    for a, b in zip(g_t, g_jax):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_alpha_gradient_alone_matches_jax():
    """alpha's cotangent asked for alone (quad does not depend on alpha)."""
    args = _inputs(P=12, M=32, seed=6)

    def loss_jax(alpha):
        a = list(map(jnp.asarray, args))
        a[7] = alpha
        ka, qd = jfp.gram_contract(*a, True, True)
        return jnp.sum(ka * ka) + jnp.sum(qd)

    g_jax = jax.jit(jax.grad(loss_jax))(jnp.asarray(args[7]))
    t_args = [torch.as_tensor(a) for a in args]
    t_args[7].requires_grad_(True)
    ka, qd = tfp.gram_contract(*t_args, True)
    (g_t,) = torch.autograd.grad(torch.sum(ka * ka) + torch.sum(qd), t_args[7])
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_jax), rtol=1e-4, atol=1e-5)


def test_cpu_path_launches_no_kernel_and_kernel_wrappers_refuse_cpu_tensors():
    args = [torch.as_tensor(a) for a in _inputs(P=8, M=16)]
    before = dict(tfp.launches)
    xs = args[5].clone().requires_grad_(True)
    ka, qd = tfp.gram_contract(*args[:5], xs, *args[6:], True)
    torch.autograd.grad(ka.sum() + qd.sum(), xs)
    assert tfp.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_gram_contract(*args, True)
    g = torch.ones(2, 8)
    kf = torch.ones(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_gram_contract_bwd_xstar(*args, kf, g, g, True)


@pytest.mark.parametrize("use_poly", [False, True])
@pytest.mark.parametrize("P", [1, 37, 50])
@pytest.mark.parametrize("M, D", _with_dims([37, 64]))
def test_plain_k2_matches_pallas_backward(use_poly, P, M, D):
    """K2's plain version, fed kF from the port's plain K1, against the x*
    cotangent of the JAX custom_vjp (Pallas backward, interpret mode)."""
    args = _inputs(P=P, M=M, D=D, seed=200 + P + M)
    wk, wq = _cotangents(P)

    def loss_jax(xs):
        a = list(map(jnp.asarray, args))
        a[5] = xs
        ka, qd = jfp.gram_contract(*a, use_poly, True)
        return jnp.sum(wk * ka) + jnp.sum(wq * qd)

    g_jax = np.asarray(jax.jit(jax.grad(loss_jax))(jnp.asarray(args[5])))
    t_args = [torch.as_tensor(a) for a in args]
    ka, qd, kf = tfp.reference_gram_contract(*t_args, use_poly, return_kf=True)
    assert kf.shape == (2, P, M)
    g_t = tfp.reference_gram_contract_bwd_xstar(*t_args, kf, torch.as_tensor(wk),
                                                torch.as_tensor(wq), use_poly)
    np.testing.assert_allclose(g_t.numpy(), g_jax, **GRAD)


def test_kf_is_saved_only_for_a_gradient_of_x_star(monkeypatch):
    """GramContract asks the forward for kF only when x*'s cotangent will be
    taken: not under no_grad, and not when only other inputs need grads."""
    args = [torch.as_tensor(a) for a in _inputs(P=6, M=16, seed=3)]
    asked = []
    plain = tfp.reference_gram_contract

    def spy(*a, **kw):
        asked.append(bool(a[11]) if len(a) > 11 else kw.get("return_kf", False))
        return plain(*a, **kw)

    monkeypatch.setattr(tfp, "reference_gram_contract", spy)
    xs = args[5].clone().requires_grad_(True)
    with torch.no_grad():
        tfp.gram_contract(*args[:5], xs, *args[6:], True)
    alpha = args[7].clone().requires_grad_(True)
    ka, _ = tfp.gram_contract(*args[:7], alpha, *args[8:], True)
    torch.autograd.grad(ka.sum(), alpha)
    ka, qd = tfp.gram_contract(*args[:5], xs, *args[6:], True)
    torch.autograd.grad(ka.sum() + qd.sum(), xs)
    assert asked == [False, False, False, True]


@pytest.mark.parametrize("structure, D", [("se", 12), ("se+p2", 24)])
def test_predict_dispatch_takes_wide_inputs(structure, D):
    """Above 8 dims the fused route is taken and agrees with the plain one:
    ``_fused_structure`` matches, the wrappers' shape check accepts up to 32
    dims and refuses 33, and ``_predict_fused`` (the CPU twins of K1/K2)
    equals ``_predict_plain``, x*'s gradient included."""
    dims = tuple(range(D))
    kern = tK.SEArd(dims) if structure == "se" else tK.se_plus_volterra(dims, 2)
    gp = MultiGP(kernel=kern, num_heads=2)
    assert gp._fused_structure() == structure
    args = [torch.as_tensor(a) for a in _inputs(P=40, M=48, D=D, seed=D)]
    params = gp.init_params(per_head_overrides=[{"member_overrides": [
        {"lengthscales": np.sqrt(D / 6.0)}, {"sigma_diag": 0.3}, {"sigma_diag": 0.3}]}] * 2
        if structure == "se+p2" else [{"lengthscales": np.sqrt(D / 6.0)}] * 2)
    post = Posterior(x_tr=args[6], mask=args[9], alpha=args[7], var_factor=0.1 * args[8],
                     norm=torch.ones(2))
    outs = []
    for predict in (gp._predict_fused, gp._predict_plain):
        xs = args[5].clone().requires_grad_(True)
        mean, var = predict(params, post, xs)
        (g,) = torch.autograd.grad(mean.sum() + var.sum(), xs)
        outs.append((mean.detach(), var.detach(), g))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
    shapes = lambda d: (torch.zeros(1, 2, d), torch.zeros(1, 40, d), torch.zeros(1, 48, d))
    assert tfp._shapes(*shapes(tfp.MAX_D))[4] == tfp.MAX_D == 32
    with pytest.raises(ValueError, match="at most 32 input dims"):
        tfp._shapes(*shapes(33))


@pytest.mark.cuda
def test_predict_on_the_card_launches_the_kernels_at_12_dims():
    """On a CUDA tensor a full-dims SE over 12 inputs runs K1 and K2 (no
    plain fallback), within FWD / GRAD of ``_predict_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gp = MultiGP(kernel=tK.SEArd(tuple(range(12))), num_heads=2)
    args = [torch.as_tensor(a, device=dev) for a in _inputs(P=400, M=192, D=12, seed=12)]
    params = gp.init_params(per_head_overrides=[{"lengthscales": np.sqrt(2.0)}] * 2, device=dev)
    post = Posterior(x_tr=args[6], mask=args[9], alpha=args[7], var_factor=0.1 * args[8],
                     norm=torch.ones(2, device=dev))
    tfp.reset_launches()
    xs = args[5].clone().requires_grad_(True)
    mean, var = gp.predict(params, post, xs)
    (g,) = torch.autograd.grad(mean.sum() + var.sum(), xs)
    assert tfp.launches == {"fwd": 1, "bwd": 1}
    xs_p = args[5].clone().requires_grad_(True)
    mean_p, var_p = gp._predict_plain(params, post, xs_p)
    (g_p,) = torch.autograd.grad(mean_p.sum() + var_p.sum(), xs_p)
    torch.testing.assert_close(mean, mean_p, **FWD)
    torch.testing.assert_close(var, var_p, **FWD)
    torch.testing.assert_close(g, g_p, **GRAD)
