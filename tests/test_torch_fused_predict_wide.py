"""The wide path of the port's fused predict (input dims above 8): the plain
twin of its generation kernel against the JAX package's masked gram, and the
launch plan that picks the wide kernels' tiles.

The generation kernel ``k1_gen`` writes the masked k* and kalpha = k* alpha
once per K1 call; its plain twin :func:`reference_gram_gen` is held here
against ``mcpilco_tpu.ops.fused_predict._reference_gram_contract``: its
kalpha with the inputs' alpha, and k* column by column, as the kalpha of a
one-hot alpha (a sum with one nonzero term, exact in float32).  Tolerance:
forward rtol 2e-5 / atol 1e-5 (tests/test_fused_predict.py).  The plan is
pure Python, so the tests call it without the built library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpilco_tpu.ops import fused_predict as jfp
from mcpilco_tpu_torch.ops import fused_predict as tfp

torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=1e-5)
# phase 2's wide shapes (G, P, M, L): the Furuta SE posterior at its first
# and sixth trial, UR5's SE+P(2), the Furuta SE farm's lanes; and Furuta
# phase 9's M=320
WIDE_SHAPES = [(2, 400, 192, 1), (2, 400, 960, 1), (6, 200, 448, 1), (2, 400, 192, 4),
               (2, 400, 320, 1)]


def _inputs(G, P, M, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [
        np.exp(0.3 * f(G, D)) * np.float32(6.0 / D), np.exp(0.2 * f(G)),
        0.1 * np.exp(0.3 * f(G, D + 1)), 0.1 * np.exp(0.3 * f(G, D)),
        0.1 * np.exp(0.3 * f(G, D)), f(P, D), f(M, D), f(G, M),
        (rng.uniform(size=(G, M)) > 0.2).astype(np.float32),
    ]


def _jax_masked_gram(arrs, use_poly):
    """(k* [G, P, M], kalpha [G, P]) of the JAX package's plain twin."""
    se_w, se_lam, p1, p2a, p2b, xs, xt, alpha, mask = (jnp.asarray(a) for a in arrs)
    G, M = alpha.shape
    k_inv = jnp.zeros((G, M, M), jnp.float32)
    kalpha_of = lambda a: jfp._reference_gram_contract(se_w, se_lam, p1, p2a, p2b, xs, xt, a,
                                                       k_inv, mask, use_poly)[0]
    onehot = jnp.broadcast_to(jnp.eye(M, dtype=jnp.float32)[:, None, :], (M, G, M))
    k = jnp.transpose(jax.vmap(kalpha_of)(onehot), (1, 2, 0))  # [M, G, P] -> [G, P, M]
    return np.asarray(k), np.asarray(kalpha_of(alpha))


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("use_poly", [False, True], ids=["se", "se+p2"])
@pytest.mark.parametrize("D", [6, 12, 24])
def test_gen_twin_matches_jax_masked_gram(D, use_poly, L):
    """reference_gram_gen, lane by lane, against the JAX masked gram at
    D in {6, 12, 24}; a lane's result does not depend on the lanes beside it
    beyond float32 summation order."""
    G, P, M = 2, 37, 70
    lanes = [_inputs(G, P, M, D, seed=100 * D + 10 * L + l) for l in range(L)]
    t = [torch.as_tensor(np.stack(a)) for a in zip(*lanes)]
    if L == 1:
        t = [a[0] for a in t]
    k, kalpha = tfp.reference_gram_gen(*t, use_poly)
    assert k.shape == ((L,) if L > 1 else ()) + (G, P, M)
    for l, arrs in enumerate(lanes):
        k_j, ka_j = _jax_masked_gram(arrs, use_poly)
        got_k, got_ka = (k[l], kalpha[l]) if L > 1 else (k, kalpha)
        np.testing.assert_allclose(got_k.numpy(), k_j, **FWD)
        np.testing.assert_allclose(got_ka.numpy(), ka_j, **FWD)
        # masked points are exact zeros in both
        dead = arrs[8] == 0
        assert np.all(got_k.numpy()[np.broadcast_to(dead[:, None, :], k_j.shape)] == 0)


def test_gram_contract_is_built_on_the_gen_twin():
    """The plain K1's kalpha and kF come from the generation twin's k*."""
    arrs = _inputs(2, 9, 20, 12, seed=3)
    t = [torch.as_tensor(a) for a in arrs]
    F = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 20, 20)).astype(np.float32))
    kalpha, quad, kf = tfp.reference_gram_contract(*t[:8], F, t[8], True, return_kf=True)
    k, ka = tfp.reference_gram_gen(*t, True)
    torch.testing.assert_close(kalpha, ka, rtol=0, atol=0)
    torch.testing.assert_close(kf, k @ F, rtol=0, atol=0)
    torch.testing.assert_close(quad, (kf * kf).sum(-1), rtol=0, atol=0)


def test_gen_wrapper_refuses_cpu_tensors():
    t = [torch.as_tensor(a) for a in _inputs(2, 8, 16, 12, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fused_gram_gen(*t, True)


@pytest.mark.parametrize("G, P, M, L", WIDE_SHAPES)
def test_wide_plan_fills_the_card(G, P, M, L):
    """No launch of the wide path runs between one and one and a half waves
    of blocks on the 132 SMs, and every tile covers its shape."""
    plan = tfp.wide_plan(G, P, M, L)
    assert plan["Pp"] % tfp.GEN_TILE[0] == 0 and P <= plan["Pp"] < P + tfp.GEN_TILE[0]
    for name in ("k1_gen", "k1_forward_wide", "k2_backward_xstar_wide"):
        bp, bn = plan[name]["tile"][:2]
        blocks = plan[name]["blocks"]
        assert blocks == L * G * -(-P // bp) * -(-M // bn), name
        assert not 1 < blocks / tfp.SMS < 1.5, (name, blocks)
    assert tfp.launch_blocks(G, P, M, L, D=12) == (plan["k1_forward_wide"]["blocks"],
                                                    plan["k2_backward_xstar_wide"]["blocks"])


@pytest.mark.parametrize("G, P, M", sorted({s[:3] for s in WIDE_SHAPES}))
def test_wide_plan_is_chosen_per_lane(G, P, M):
    """A lane's summation order does not depend on how many lanes share the
    launch, so lane l stays bitwise its L=1 launch: K1's tile is one lane's;
    K2's may take more particles per block and another register budget at
    more lanes, but all its configurations keep its points and slices."""
    one = tfp.wide_plan(G, P, M)
    for L in (2, 4, 8):
        many = tfp.wide_plan(G, P, M, L)
        k1, k2 = "k1_forward_wide", "k2_backward_xstar_wide"
        assert many[k1]["config"] == one[k1]["config"]
        assert many[k1]["blocks"] == L * one[k1]["blocks"]
        assert many[k2]["tile"][1:3] == one[k2]["tile"][1:3]
        assert many[k2]["tile"][0] >= one[k2]["tile"][0]


def test_wide_plan_tiles():
    """The configurations the plan picks at phase 2's wide shapes (the
    largest tile that runs 1.5 waves or more; K2 with the register budget
    that holds its grid at once where one does)."""
    pick = lambda G, P, M, L=1: tuple(tfp.wide_plan(G, P, M, L)[k]["tile"]
                                      for k in ("k1_forward_wide", "k2_backward_xstar_wide"))
    assert pick(2, 400, 192) == ((16, 32, 4), (16, 32, 2, 5))
    assert pick(2, 400, 192, 4) == ((16, 32, 4), (32, 32, 2, 5))
    assert pick(2, 400, 960) == ((64, 64, 1), (32, 32, 2, 6))
    assert pick(6, 200, 448) == ((32, 64, 2), (32, 32, 2, 5))
    assert pick(2, 400, 320) == ((16, 32, 4), (32, 32, 2, 4))


@pytest.mark.cuda
def test_gen_kernel_matches_its_twin_on_the_card():
    """k1_gen (fused_gram_gen) against reference_gram_gen on the card, at
    UR5's width and with lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for use_poly, G, P, M, D, L in ((True, 6, 200, 448, 24, 1), (False, 2, 37, 70, 12, 3)):
        lanes = [_inputs(G, P, M, D, seed=7 + l) for l in range(L)]
        t = [torch.as_tensor(np.stack(a), device=dev) for a in zip(*lanes)]
        got = tfp.fused_gram_gen(*t, use_poly)
        want = tfp.reference_gram_gen(*t, use_poly)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **FWD)
