"""The port's GP stack (kernels, masked linear algebra, MultiGP, SOD) against
the JAX package on the same numpy inputs.

Golden math runs in float64 on both sides (the ``x64`` fixture and
torch.float64), where the two differ only by summation order: rtol 1e-9.
The 30-epoch fit runs in float32, as in production: rtol 1e-4 on the loss
history, since Adam's steps compound float32 rounding over the epochs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpilco_tpu.models import gp as jgp
from mcpilco_tpu.models import kernels as jK
from mcpilco_tpu.models import sod as jsod
from mcpilco_tpu_torch.models import gp as tgp
from mcpilco_tpu_torch.models import kernels as tK
from mcpilco_tpu_torch.models import sod as tsod
from mcpilco_tpu_torch.ops import linalg as tlinalg
from mcpilco_tpu_torch.utils.convert import to_torch

torch.set_num_threads(1)

GOLD = dict(rtol=1e-9, atol=1e-12)
D = 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _kernels(kind):
    dims = tuple(range(D))
    if kind == "se":
        return jK.SEArd(active_dims=dims), tK.SEArd(active_dims=dims)
    return jK.se_plus_volterra(dims, degree=2), tK.se_plus_volterra(dims, degree=2)


def _perturbed_params(jgp_obj, rng, scale=0.3, dtype=jnp.float64):
    """JAX GPParams with every leaf moved off its init value (mean and
    outputscale included, so the whole formula is exercised)."""
    params = jgp_obj.init_params(sigma_n=0.2, dtype=dtype)
    leaves, tdef = jax.tree_util.tree_flatten(params)
    leaves = [l + scale * rng.standard_normal(l.shape).astype(l.dtype) for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _data(rng, n=50, cap=64, G=2, dtype=np.float64, spread=1.0):
    x = np.zeros((cap, D), dtype)
    y = np.zeros((G, cap), dtype)
    x[:n] = spread * rng.standard_normal((n, D))
    y[:, :n] = np.stack([np.sin(x[:n, 0]) + 0.1 * x[:n, 1], np.cos(x[:n, 2]) * x[:n, 5]])
    mask = np.zeros(cap, dtype)
    mask[:n] = 1.0
    return x, y, mask


def _both_gps(kind, **kw):
    jk, tk = _kernels(kind)
    return jgp.MultiGP(kernel=jk, num_heads=2, **kw), tgp.MultiGP(kernel=tk, num_heads=2, **kw)


@pytest.mark.parametrize("kind", ["se", "se+p2"])
def test_kernel_gram_diag_mean(x64, kind):
    rng = np.random.default_rng(1)
    jg, tg = _both_gps(kind)
    params = _perturbed_params(jg, rng)
    kp_np = _np_tree(params.kernel)
    kp_t = to_torch(kp_np, "cpu")
    x1, x2 = rng.standard_normal((9, D)), rng.standard_normal((7, D))
    gram_j = jax.vmap(lambda p: jg.kernel.gram(p, jnp.asarray(x1), jnp.asarray(x2)))(params.kernel)
    diag_j = jax.vmap(lambda p: jg.kernel.diag(p, jnp.asarray(x1)))(params.kernel)
    mean_j = jax.vmap(lambda p: jg.kernel.mean(p, jnp.asarray(x1)))(params.kernel)
    t1, t2 = torch.as_tensor(x1), torch.as_tensor(x2)
    np.testing.assert_allclose(tg.kernel.gram(kp_t, t1, t2).numpy(), np.asarray(gram_j), **GOLD)
    np.testing.assert_allclose(tg.kernel.diag(kp_t, t1).numpy(), np.asarray(diag_j), **GOLD)
    np.testing.assert_allclose(tg._mean(kp_t, t1).numpy(), np.asarray(mean_j), **GOLD)
    np.testing.assert_allclose(tK.sq_dist(t1, t2).numpy(),
                               np.asarray(jK.sq_dist(jnp.asarray(x1), jnp.asarray(x2))), **GOLD)


@pytest.mark.parametrize("kind", ["se", "se+p2"])
def test_mll_posterior_predict(x64, kind):
    rng = np.random.default_rng(2)
    jg, tg = _both_gps(kind)
    params = _perturbed_params(jg, rng)
    x, y, mask = _data(rng)
    jdata = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    tparams = to_torch(_np_tree(params), "cpu", into=tgp.GPParams)

    np.testing.assert_allclose(float(tg.mll(tparams, tdata)), float(jax.jit(jg.mll)(params, jdata)),
                               **GOLD)

    jpost = jax.jit(jg.fit_posterior)(params, jdata)
    tpost = tg.fit_posterior(tparams, tdata)
    for name in ("alpha", "var_factor", "norm", "mask"):
        np.testing.assert_allclose(getattr(tpost, name).numpy(), np.asarray(getattr(jpost, name)),
                                   rtol=1e-9, atol=1e-10, err_msg=name)

    xs = rng.standard_normal((33, D))
    m_j, v_j = jax.jit(jg.predict)(params, jpost, jnp.asarray(xs))
    for fn in (tg.predict, tg._predict_plain, tg._predict_fused):
        m_t, v_t = fn(tparams, tpost, torch.as_tensor(xs))
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **GOLD)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **GOLD)
    assert tg._fused_structure() == kind


def test_fit_matches_jax_for_30_epochs():
    rng = np.random.default_rng(3)
    jg, tg = _both_gps("se+p2")
    x, y, mask = _data(rng, dtype=np.float32)
    params = jg.init_params(sigma_n=1.0)
    jdata = jgp.GPData(x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.asarray(mask))
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    jp, jl = jax.jit(lambda p, d: jg.fit(p, d, num_epochs=30, learning_rate=0.05))(params, jdata)
    tp, tl = tg.fit(to_torch(_np_tree(params), "cpu", into=tgp.GPParams), tdata,
                    num_epochs=30, learning_rate=0.05)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), tp, is_leaf=torch.is_tensor))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)
    # the SE outputscale and mean are frozen leaves: untouched
    assert float(tp.kernel[0]["log_lambda"].abs().max()) == 0.0
    assert float(tp.kernel[0]["mean"].abs().max()) == 0.0


def test_fit_backtracks_over_a_non_finite_epoch():
    """A NaN loss reverts params and Adam state to the last finite iterate,
    logs the last finite loss, halves the step scale, and the fit goes on."""

    @dataclasses.dataclass(frozen=True)
    class FlakyGP(tgp.MultiGP):
        calls: list = dataclasses.field(default_factory=list)

        def mll(self, params, data, norm=None):
            self.calls.append(None)
            loss = super().mll(params, data, norm)
            return loss * float("nan") if len(self.calls) == 4 else loss

    rng = np.random.default_rng(4)
    x, y, mask = _data(rng, dtype=np.float32)
    tdata = tgp.GPData(*(torch.as_tensor(a) for a in (x, y, mask)))
    gp = FlakyGP(kernel=tK.SEArd(active_dims=tuple(range(D))), num_heads=2)
    p0 = gp.init_params(sigma_n=1.0)
    _, hist = gp.fit(p0, tdata, num_epochs=8, learning_rate=0.05)
    clean = tgp.MultiGP(kernel=gp.kernel, num_heads=2)
    _, ref = clean.fit(p0, tdata, num_epochs=3, learning_rate=0.05)
    h = hist.numpy()
    assert np.all(np.isfinite(h))
    np.testing.assert_allclose(h[:3], ref.numpy(), rtol=1e-6)
    assert h[3] == h[2]  # the NaN epoch logs the last finite loss
    # epoch 5 re-evaluates the epoch-3 iterate (the last good one): same loss
    np.testing.assert_allclose(h[4], h[2], rtol=1e-6)
    assert h[7] < h[4]


def test_sod_select_masks_identical(x64):
    rng = np.random.default_rng(5)
    jg, tg = _both_gps("se+p2")
    params = _perturbed_params(jg, rng, scale=0.1)
    x, y, mask = _data(rng, n=56, spread=0.2)
    cfg_j = jsod.SODConfig(threshold_mode="relative", threshold=(0.5,))
    cfg_t = tsod.SODConfig(threshold_mode="relative", threshold=(0.5,))
    sel_j = jsod.select(jg, cfg_j, params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    sel_t = tsod.select(tg, cfg_t, to_torch(_np_tree(params), "cpu", into=tgp.GPParams),
                        *(torch.as_tensor(a) for a in (x, y, mask)))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert 0 < sel_t.sum() < 2 * 56  # a real subset, not all or nothing


def test_masked_cholesky_returns_nan_on_non_pd_gram():
    K = torch.tensor([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.5], [0.5, 1.0]]])
    mask = torch.ones(2, 2)
    L = tlinalg.masked_cholesky(K, mask)
    assert torch.isnan(L[0]).all()
    torch.testing.assert_close(L[1] @ L[1].T, K[1])
    # padded rows are identity rows and the valid block factorizes
    L2 = tlinalg.masked_cholesky(K[:1], torch.tensor([[1.0, 0.0]]))
    torch.testing.assert_close(L2[0], torch.eye(2))
