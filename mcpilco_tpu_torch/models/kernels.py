"""GP kernel algebra on tensors.

A kernel is a frozen config object paired with a parameter tree made by
:meth:`Kernel.init_params` (a dict per kernel, a tuple of member dicts for
:class:`Sum` and :class:`Product`, ``{"base": ...}`` nested in
:class:`Scaled`), as in ``mcpilco_tpu/models/kernels.py``.  Every leaf may
carry leading batch axes (the GP's head axis G): ``gram(params, X1, X2)``
then returns ``[*B, N1, N2]``, so all heads are evaluated by one set of
batched ops instead of a ``vmap``.  ``mean`` and ``diag`` return ``[*B, N]``
where the kernel has per-head parameters in them, else a batch axis of 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils import consts


def _as_tuple(x) -> Optional[Tuple[int, ...]]:
    if x is None:
        return None
    return tuple(int(i) for i in np.asarray(x).reshape(-1))


def _take_dims(X: torch.Tensor, dims: Optional[Tuple[int, ...]]) -> torch.Tensor:
    if dims is None or list(dims) == list(range(X.shape[-1])):
        return X
    return X[..., consts.index(dims, X.device)]


def sq_dist(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances by direct elementwise differences.

    Never ``torch.cdist``: above 25 rows it switches to the
    ``|a|^2 + |b|^2 - 2ab`` matmul form, whose cancellation the GP posterior
    amplifies by ``|alpha| ~ 1e2`` (``mcpilco_tpu/models/kernels.py:67-80``).
    """
    d = A[..., :, None, :] - B[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def _full(shape, value, dtype, device):
    return torch.full(shape, float(value), dtype=dtype, device=device)


class Kernel:
    """Base class: static config; params are trees from :meth:`init_params`."""

    def init_params(self, dtype=torch.float32, device="cpu", **overrides):
        raise NotImplementedError

    def param_mask(self, params):
        """Tree of booleans (matching ``params``) marking trainable leaves."""
        raise NotImplementedError

    def gram(self, params, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """Noise-free covariance k(X1, X2): [*B, N1, N2]."""
        raise NotImplementedError

    def diag(self, params, X: torch.Tensor) -> torch.Tensor:
        """Diagonal of k(X, X): [*B, N]."""
        raise NotImplementedError

    def mean(self, params, X: torch.Tensor) -> torch.Tensor:
        """Prior mean m(X): zero, [N] with X's batch axes."""
        return torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class SEArd(Kernel):
    """k(x, x') = exp(log_lambda) * exp(-sum_d ((x_d - x'_d) / l_d)^2)."""

    active_dims: Optional[Tuple[int, ...]] = None
    num_features: Optional[int] = None
    train_lengthscales: bool = True
    train_outputscale: bool = False
    train_mean: bool = False

    def __post_init__(self):
        object.__setattr__(self, "active_dims", _as_tuple(self.active_dims))

    def _nfeat(self) -> int:
        if self.active_dims is not None:
            return len(self.active_dims)
        if self.num_features is None:
            raise ValueError("SEArd needs active_dims or num_features")
        return self.num_features

    def init_params(self, lengthscales=None, outputscale=None, mean=None,
                    dtype=torch.float32, device="cpu") -> dict:
        nf = self._nfeat()
        ls = _full((nf,), 1.0, dtype, device)
        if lengthscales is not None:
            ls = ls * torch.as_tensor(lengthscales, dtype=dtype, device=device)
        lam = _full((), 1.0 if outputscale is None else outputscale, dtype, device)
        mu = _full((), 0.0 if mean is None else mean, dtype, device)
        return {"log_lengthscales": torch.log(ls), "log_lambda": torch.log(lam), "mean": mu}

    def param_mask(self, params) -> dict:
        return {
            "log_lengthscales": self.train_lengthscales,
            "log_lambda": self.train_outputscale,
            "mean": self.train_mean,
        }

    def gram(self, params, X1, X2):
        # weighted direct differences: the head-independent diff^2 is
        # computed once and the per-head inverse squared lengthscales enter
        # as a positive-weighted reduce (cancellation-free, see sq_dist)
        a = _take_dims(X1, self.active_dims)
        b = _take_dims(X2, self.active_dims)
        diff = a[..., :, None, :] - b[..., None, :, :]
        w = torch.exp(-2.0 * params["log_lengthscales"])
        d = torch.sum(diff * diff * w[..., None, None, :], dim=-1)
        return torch.exp(params["log_lambda"])[..., None, None] * torch.exp(-d)

    def diag(self, params, X):
        ones = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
        return torch.exp(params["log_lambda"])[..., None] * ones

    def mean(self, params, X):
        ones = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
        return params["mean"][..., None] * ones


def _offset_phi(X, dims, offset: bool):
    """Features x[dims], with a constant 1 column appended when ``offset``."""
    Xa = _take_dims(X, dims)
    if offset:
        Xa = torch.cat([Xa, torch.ones_like(Xa[..., :1])], dim=-1)
    return Xa


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """Dot-product kernel k(x, x') = phi(x)^T Sigma phi(x').

    phi(x) = x[active_dims] (+ a constant 1 column when ``offset``).  Sigma is
    diagonal, diag(exp(log_sigma_diag)^2); with ``full_sigma`` it is U^T U,
    U upper triangular with diagonal exp(log_sigma_diag) and the strict upper
    triangle ``sigma_offdiag`` (row-major); with ``semi_def_dims`` the first
    entries of the diagonal are squares of the unconstrained
    ``sigma_free_diag`` (the reference's ``diagonal_covariance_semi_def``),
    so training can switch features off.  ``mean_w`` (given at init) makes
    the prior mean phi(x)^T mean_w.
    """

    active_dims: Optional[Tuple[int, ...]] = None
    num_features: Optional[int] = None
    offset: bool = False
    full_sigma: bool = False
    semi_def_dims: int = 0
    train_sigma: bool = True
    train_mean: bool = False

    def __post_init__(self):
        object.__setattr__(self, "active_dims", _as_tuple(self.active_dims))
        if self.full_sigma and self.semi_def_dims:
            raise ValueError("full_sigma and semi_def_dims are mutually exclusive")

    def _nfeat(self) -> int:
        base = len(self.active_dims) if self.active_dims is not None else self.num_features
        if base is None:
            raise ValueError("Linear needs active_dims or num_features")
        return base + (1 if self.offset else 0)

    def phi(self, X):
        return _offset_phi(X, self.active_dims, self.offset)

    def init_params(self, sigma_diag=None, mean_w=None, free_chol=None, dtype=torch.float32,
                    device="cpu") -> dict:
        nf = self._nfeat()
        as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        sd = _full((nf,), 1.0, dtype, device)
        if sigma_diag is not None:
            sd = sd * as_t(sigma_diag)
        if self.semi_def_dims:
            p = {"sigma_free_diag": sd[: self.semi_def_dims],
                 "log_sigma_diag": torch.log(sd[self.semi_def_dims:])}
        else:
            p = {"log_sigma_diag": torch.log(sd)}
            if self.full_sigma:
                n_off = nf * (nf - 1) // 2
                p["sigma_offdiag"] = (_full((n_off,), 0.0, dtype, device) if free_chol is None
                                      else as_t(free_chol))
        if mean_w is not None:
            p["mean_w"] = as_t(mean_w)
        return p

    def param_mask(self, params) -> dict:
        m = {"log_sigma_diag": self.train_sigma}
        if self.full_sigma:
            m["sigma_offdiag"] = self.train_sigma
        if self.semi_def_dims:
            m["sigma_free_diag"] = self.train_sigma
        if "mean_w" in params:
            m["mean_w"] = self.train_mean
        return m

    def _sigma(self, params):
        """(Sigma [*B, nf, nf], None) with ``full_sigma``, else (None, its
        diagonal [*B, nf])."""
        d = torch.exp(params["log_sigma_diag"])
        if self.semi_def_dims:
            d = torch.cat([params["sigma_free_diag"], d], dim=-1)
        if not self.full_sigma:
            return None, d * d
        nf = d.shape[-1]
        iu = torch.triu_indices(nf, nf, offset=1, device=d.device)
        U = torch.zeros(d.shape + (nf,), dtype=d.dtype, device=d.device)
        U[..., iu[0], iu[1]] = params["sigma_offdiag"]
        U = U + torch.diag_embed(d)
        return U.mT @ U, None

    def gram(self, params, X1, X2):
        p1, p2 = self.phi(X1), self.phi(X2)
        S, diag = self._sigma(params)
        if S is None:
            return (p1 * diag[..., None, :]) @ p2.mT
        return p1 @ (S @ p2.mT)

    def diag(self, params, X):
        p = self.phi(X)
        S, diag = self._sigma(params)
        if S is None:
            return torch.sum(p * p * diag[..., None, :], dim=-1)
        return torch.sum((p @ S) * p, dim=-1)

    def mean(self, params, X):
        if "mean_w" in params:
            return (self.phi(X) @ params["mean_w"][..., :, None])[..., 0]
        return super().mean(params, X)

    def weight_posterior(self, params, noise_var, X, Y, mask=None):
        """Posterior mean of the regression weights w per head (the matrix
        inversion lemma with sigma_n^-2 scaling): X [N, D], Y [*B, N]."""
        p = self.phi(X)
        if mask is not None:
            p = p * mask[..., None]
            Y = Y * mask
        S, diag = self._sigma(params)
        Sigma = torch.diag_embed(diag) if S is None else S
        noise_var = torch.as_tensor(noise_var, dtype=p.dtype, device=p.device)[..., None, None]
        A = torch.linalg.inv(Sigma) + (p.mT @ p) / noise_var
        return torch.linalg.solve(A, p.mT @ Y[..., None])[..., 0] / noise_var[..., 0]


@dataclasses.dataclass(frozen=True)
class Poly(Kernel):
    """Polynomial kernel: (linear covariance)^degree."""

    base: Linear = None
    degree: int = 2

    def init_params(self, dtype=torch.float32, device="cpu", **kw) -> dict:
        return self.base.init_params(dtype=dtype, device=device, **kw)

    def param_mask(self, params) -> dict:
        return self.base.param_mask(params)

    def gram(self, params, X1, X2):
        return self.base.gram(params, X1, X2) ** self.degree

    def diag(self, params, X):
        return self.base.diag(params, X) ** self.degree


def _product(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The product over ``dim`` as a chain of multiplications, the same
    values as ``torch.prod``: its backward counts the input's zeros on the
    host, which the optimizer's CUDA graph cannot capture."""
    out, *rest = t.unbind(dim)
    for f in rest:
        out = out * f
    return out


@dataclasses.dataclass(frozen=True)
class MPK(Kernel):
    """Multiplicative Polynomial Kernel of a given degree:

    k(x, x') = prod_{d=1..degree} phi(x)^T diag(exp(log_sigma[d])^2) phi(x')
    with the per-degree diagonals held in one [degree, nfeat] leaf.
    """

    active_dims: Optional[Tuple[int, ...]] = None
    num_features: Optional[int] = None
    degree: int = 1
    offset: bool = True
    train_sigma: bool = True

    def __post_init__(self):
        object.__setattr__(self, "active_dims", _as_tuple(self.active_dims))

    def _nfeat(self) -> int:
        base = len(self.active_dims) if self.active_dims is not None else self.num_features
        if base is None:
            raise ValueError("MPK needs active_dims or num_features")
        return base + (1 if self.offset else 0)

    def phi(self, X):
        return _offset_phi(X, self.active_dims, self.offset)

    def init_params(self, sigma_diag=None, dtype=torch.float32, device="cpu") -> dict:
        nf = self._nfeat()
        sd = _full((self.degree, nf), 1.0, dtype, device)
        if sigma_diag is not None:
            s = torch.as_tensor(sigma_diag, dtype=dtype, device=device)
            sd = sd * s if s.ndim < 2 else s.reshape(self.degree, nf)
        return {"log_sigma_diag": torch.log(sd)}

    def param_mask(self, params) -> dict:
        return {"log_sigma_diag": self.train_sigma}

    def gram(self, params, X1, X2):
        p1, p2 = self.phi(X1), self.phi(X2)
        diag = torch.exp(2.0 * params["log_sigma_diag"])  # [*B, degree, nf]
        a = p1.unsqueeze(-3) * diag.unsqueeze(-2)  # [*B, degree, N1, nf]
        g = a @ p2.unsqueeze(-3).transpose(-1, -2)  # [*B, degree, N1, N2]
        return _product(g, dim=-3)

    def diag(self, params, X):
        p = self.phi(X)
        diag = torch.exp(2.0 * params["log_sigma_diag"])
        g = torch.sum((p * p).unsqueeze(-3) * diag.unsqueeze(-2), dim=-1)  # [*B, degree, N]
        return _product(g, dim=-2)


@dataclasses.dataclass(frozen=True)
class Sum(Kernel):
    """Sum of kernels; params are a tuple of member params (the mean is
    summed over all members)."""

    members: Tuple[Kernel, ...] = ()

    def init_params(self, member_overrides=None, dtype=torch.float32, device="cpu") -> tuple:
        ov = member_overrides or [{}] * len(self.members)
        return tuple(
            k.init_params(dtype=dtype, device=device, **o) for k, o in zip(self.members, ov)
        )

    def param_mask(self, params) -> tuple:
        return tuple(k.param_mask(p) for k, p in zip(self.members, params))

    def gram(self, params, X1, X2):
        out = self.members[0].gram(params[0], X1, X2)
        for k, p in zip(self.members[1:], params[1:]):
            out = out + k.gram(p, X1, X2)
        return out

    def diag(self, params, X):
        out = self.members[0].diag(params[0], X)
        for k, p in zip(self.members[1:], params[1:]):
            out = out + k.diag(p, X)
        return out

    def mean(self, params, X):
        out = self.members[0].mean(params[0], X)
        for k, p in zip(self.members[1:], params[1:]):
            out = out + k.mean(p, X)
        return out


@dataclasses.dataclass(frozen=True)
class Product(Kernel):
    """Elementwise product of kernels; params are a tuple of member params."""

    members: Tuple[Kernel, ...] = ()

    def init_params(self, member_overrides=None, dtype=torch.float32, device="cpu") -> tuple:
        ov = member_overrides or [{}] * len(self.members)
        return tuple(
            k.init_params(dtype=dtype, device=device, **o) for k, o in zip(self.members, ov)
        )

    def param_mask(self, params) -> tuple:
        return tuple(k.param_mask(p) for k, p in zip(self.members, params))

    def gram(self, params, X1, X2):
        out = self.members[0].gram(params[0], X1, X2)
        for k, p in zip(self.members[1:], params[1:]):
            out = out * k.gram(p, X1, X2)
        return out

    def diag(self, params, X):
        out = self.members[0].diag(params[0], X)
        for k, p in zip(self.members[1:], params[1:]):
            out = out * k.diag(p, X)
        return out

    def mean(self, params, X):
        out = self.members[0].mean(params[0], X)
        for k, p in zip(self.members[1:], params[1:]):
            out = out * k.mean(p, X)
        return out


@dataclasses.dataclass(frozen=True)
class Scaled(Kernel):
    """y(x) = a(x) f(x):  k(x, x') = a(x) k_f(x, x') a(x').

    ``f_scale(pos_par, free_par, X_active)`` maps the parameters (each with
    the head axes in front, or None) and the inputs x[active_dims_scale]
    [..., N, d] to a(x) [..., N]; :func:`scale_sign` and
    :func:`scale_sign_abs` are the reference's scaling functions.
    """

    base: Kernel = None
    f_scale: Callable = None
    active_dims_scale: Optional[Tuple[int, ...]] = None
    n_pos_par: int = 0
    n_free_par: int = 0
    train_scale: bool = True

    def __post_init__(self):
        object.__setattr__(self, "active_dims_scale", _as_tuple(self.active_dims_scale))

    def init_params(self, pos_par=None, free_par=None, dtype=torch.float32, device="cpu",
                    **base_kw) -> dict:
        p = {"base": self.base.init_params(dtype=dtype, device=device, **base_kw)}
        if self.n_pos_par:
            pp = _full((self.n_pos_par,), 1.0, dtype, device)
            if pos_par is not None:
                pp = torch.as_tensor(pos_par, dtype=dtype, device=device)
            p["log_pos_par"] = torch.log(pp)
        if self.n_free_par:
            p["free_par"] = (_full((self.n_free_par,), 0.0, dtype, device) if free_par is None
                             else torch.as_tensor(free_par, dtype=dtype, device=device))
        return p

    def param_mask(self, params) -> dict:
        m = {"base": self.base.param_mask(params["base"])}
        if self.n_pos_par:
            m["log_pos_par"] = self.train_scale
        if self.n_free_par:
            m["free_par"] = self.train_scale
        return m

    def _a(self, params, X):
        pos = torch.exp(params["log_pos_par"]) if self.n_pos_par else None
        return self.f_scale(pos, params.get("free_par"), _take_dims(X, self.active_dims_scale))

    def gram(self, params, X1, X2):
        a1, a2 = self._a(params, X1), self._a(params, X2)
        return a1[..., :, None] * self.base.gram(params["base"], X1, X2) * a2[..., None, :]

    def diag(self, params, X):
        a = self._a(params, X)
        return a * a * self.base.diag(params["base"], X)

    def mean(self, params, X):
        return self._a(params, X) * self.base.mean(params["base"], X)


# Scaling functions for :class:`Scaled`: (pos_par, free_par, X_active) ->
# a [..., N].  A parameter [*B, n] meets X_active [..., N, d] with a point
# axis inserted, so per-head parameters give per-head scalings.


def scale_sign(pos_par, free_par, X_active, positive: bool = True):
    """Indicator: 1 where EVERY active dim is > free_par (default 0), else 0;
    ``positive=False`` flips the comparison."""
    offset = free_par[..., None, :] if free_par is not None else 0.0
    cmp = (X_active > offset) if positive else (X_active < offset)
    return torch.prod(cmp.to(X_active.dtype), dim=-1)


def scale_sign_abs(pos_par, free_par, X_active, positive: bool = True):
    """Indicator on magnitudes: 1 where every |active dim| is above (below)
    the positive threshold ``pos_par``."""
    thr = pos_par[..., None, :]
    cmp = (torch.abs(X_active) > thr) if positive else (torch.abs(X_active) < thr)
    return torch.prod(cmp.to(X_active.dtype), dim=-1)


def volterra_mpk(active_dims, degree: int, train_sigma: bool = True) -> Sum:
    """Sum over d = 1..degree of MPK(d); degree 1 carries the offset column."""
    members = [MPK(active_dims=active_dims, degree=1, offset=True, train_sigma=train_sigma)]
    for d in range(2, degree + 1):
        members.append(MPK(active_dims=active_dims, degree=d, offset=False, train_sigma=train_sigma))
    return Sum(members=tuple(members))


def se_plus_volterra(active_dims, degree: int = 2, train_outputscale: bool = False) -> Sum:
    """The SE+P(degree) kernel of the flagship cart-pole config."""
    return Sum(
        members=(
            SEArd(active_dims=active_dims, train_outputscale=train_outputscale),
            *volterra_mpk(active_dims, degree).members,
        )
    )
