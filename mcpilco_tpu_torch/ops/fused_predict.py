"""Fused multi-head GP posterior prediction: two CUDA kernels and their twin.

The rollout evaluates, per scan step and per GP head,

    k* = k(x*, X_tr)            (SE-ARD, optionally + Volterra-MPK(2))
    kalpha = k* @ alpha
    quad   = sum((k* @ F)^2, -1)      (F = Posterior.var_factor)

``csrc/fused_predict.cu`` computes this chain in one kernel per call (K1)
and x*'s cotangent in a second (K2); they replace the Pallas kernels
``fused_gram_contract`` and ``fused_gram_contract_bwd_xstar`` of
``mcpilco_tpu/ops/fused_predict.py``.  :class:`GramContract` is the autograd
function around them.  On a CUDA tensor it launches the kernels or raises; on
a CPU tensor it uses :func:`reference_gram_contract`, the plain PyTorch twin,
which is also the oracle the kernels are held against on the card.

The kernels are built from the checkout's sources with ``nvcc`` for
``sm_90a`` at first use, into ``mcpilco_tpu_torch/_build/``, and bound
through ``ctypes`` with a plain C interface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_predict.cu"
BUILD_DIR = _PKG / "_build"

# Kernel launches by the wrappers below, one per launch.
launches = {"fwd": 0, "bwd": 0}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build():
    """Compile the kernels unless this source is already built.

    Returns ``(path of the shared library, compiler log)``; the log holds
    ``ptxas``'s register and shared-memory report when a build ran.
    """
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"libfused_predict_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fp_forward.argtypes = [ptr] * 12 + [i32] * 5 + [ptr]
        lib.fp_forward.restype = i32
        lib.fp_backward_xstar.argtypes = [ptr] * 13 + [i32] * 5 + [ptr]
        lib.fp_backward_xstar.restype = i32
        lib.fp_error_string.argtypes = [i32]
        lib.fp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fp_error_string(err).decode()} ({err})")


_ARG_NAMES = ("se_w", "se_lam", "poly1", "poly2a", "poly2b", "x_star", "x_tr", "alpha",
              "var_factor", "mask", "g1", "g2")


def _validate(tensors, shapes, device):
    if device.type != "cuda":
        raise ValueError(f"the kernels run on a CUDA device, got {device}")
    for name, t, shape in zip(_ARG_NAMES, tensors, shapes):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous float32 tensors on {device}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _shapes(se_w, x_star, x_tr):
    G, D = se_w.shape
    P, M = x_star.shape[0], x_tr.shape[0]
    if P == 0 or M == 0:
        raise ValueError("the kernels need at least one particle and one training point")
    return G, P, M, D, [(G, D), (G,), (G, D + 1), (G, D), (G, D), (P, D), (M, D), (G, M),
                        (G, M, M), (G, M), (G, P), (G, P)]


def fused_gram_contract(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor,
                        mask, use_poly: bool):
    """K1 on the card: returns (kalpha [G, P], quad [G, P]).

    se_w [G, D] inverse squared lengthscales; se_lam [G] outputscales;
    poly1 [G, D+1], poly2a/b [G, D]; x_star [P, D]; x_tr [M, D];
    alpha [G, M]; var_factor [G, M, M] (F); mask [G, M].
    """
    args = (se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor, mask)
    G, P, M, D, shapes = _shapes(se_w, x_star, x_tr)
    _validate(args, shapes, x_star.device)
    lib = _library()
    kalpha = torch.empty((G, P), dtype=torch.float32, device=x_star.device)
    quad = torch.empty_like(kalpha)
    err = lib.fp_forward(
        *(t.data_ptr() for t in args), kalpha.data_ptr(), quad.data_ptr(),
        G, P, M, D, int(bool(use_poly)), torch.cuda.current_stream(x_star.device).cuda_stream,
    )
    _check_launch(lib, err, "fp_forward")
    launches["fwd"] += 1
    return kalpha, quad


def fused_gram_contract_bwd_xstar(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                                  var_factor, mask, g1, g2, use_poly: bool):
    """K2 on the card: d(loss)/d(x_star) [P, D] for cotangents g1, g2 [G, P]
    of (kalpha, quad).  The kernel writes per-head partials; the heads are
    summed here."""
    args = (se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor, mask, g1, g2)
    G, P, M, D, shapes = _shapes(se_w, x_star, x_tr)
    _validate(args, shapes, x_star.device)
    lib = _library()
    dxp = torch.empty((G, P, D), dtype=torch.float32, device=x_star.device)
    err = lib.fp_backward_xstar(
        *(t.data_ptr() for t in args), dxp.data_ptr(),
        G, P, M, D, int(bool(use_poly)), torch.cuda.current_stream(x_star.device).cuda_stream,
    )
    _check_launch(lib, err, "fp_backward_xstar")
    launches["bwd"] += 1
    return dxp.sum(dim=0)


def reference_gram_contract(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                            var_factor, mask, use_poly: bool):
    """Plain PyTorch twin of K1 (same formulas): the CPU path, the source of
    every gradient but x*'s on the card, and the kernels' oracle."""
    diff = x_star[:, None, :] - x_tr[None, :, :]  # [P, M, D]
    d = torch.einsum("pmd,gd->gpm", diff * diff, se_w)
    k = se_lam[:, None, None] * torch.exp(-d)
    if use_poly:
        lin1 = torch.einsum("pd,gd,md->gpm", x_star, poly1[:, :-1], x_tr) + poly1[:, -1:, None]
        a2 = torch.einsum("pd,gd,md->gpm", x_star, poly2a, x_tr)
        b2 = torch.einsum("pd,gd,md->gpm", x_star, poly2b, x_tr)
        k = k + lin1 + a2 * b2
    k = k * mask[:, None, :]
    kalpha = torch.einsum("gpm,gm->gp", k, alpha)
    kf = torch.matmul(k, var_factor)
    return kalpha, torch.sum(kf * kf, dim=-1)


def _prep(t):
    return t.detach().to(torch.float32).contiguous()


class GramContract(torch.autograd.Function):
    """(kalpha, quad) of the fused contraction, differentiable.

    x*'s cotangent comes from K2 on the card.  Every other input's cotangent
    comes from the twin, and only when ``ctx.needs_input_grad`` asks for it:
    in the policy loop the posterior and hyperparameters are constants, so
    only K1 and K2 run.
    """

    @staticmethod
    def forward(ctx, se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor,
                mask, use_poly):
        args = (se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor, mask)
        ctx.use_poly = use_poly
        ctx.save_for_backward(*args)
        if x_star.is_cuda:
            return fused_gram_contract(*(_prep(t) for t in args), use_poly)
        return reference_gram_contract(*args, use_poly)

    @staticmethod
    def backward(ctx, g_kalpha, g_quad):
        args = ctx.saved_tensors
        x_star = args[5]
        zeros = x_star.new_zeros(args[0].shape[0], x_star.shape[0])
        g1 = zeros if g_kalpha is None else g_kalpha
        g2 = zeros if g_quad is None else g_quad
        grads = [None] * len(args)
        needs = list(ctx.needs_input_grad[: len(args)])
        if needs[5] and x_star.is_cuda:
            grads[5] = fused_gram_contract_bwd_xstar(
                *(_prep(t) for t in args), _prep(g1), _prep(g2), ctx.use_poly
            ).to(x_star.dtype)
            needs[5] = False
        wanted = [i for i, n in enumerate(needs) if n]
        if wanted:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(args)]
                out = reference_gram_contract(*leaves, ctx.use_poly)
                got = torch.autograd.grad(out, [leaves[i] for i in wanted], (g1, g2),
                                          allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (*grads, None)


def gram_contract(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor, mask,
                  use_poly: bool):
    return GramContract.apply(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                              var_factor, mask, use_poly)
