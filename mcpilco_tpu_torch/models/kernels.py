"""GP kernel algebra on tensors: the kernels of the flagship configs.

A kernel is a frozen config object paired with a parameter tree made by
:meth:`Kernel.init_params` (a dict per kernel, a tuple of member dicts for
:class:`Sum`), as in ``mcpilco_tpu/models/kernels.py``.  Every leaf may carry
leading batch axes (the GP's head axis G): ``gram(params, X1, X2)`` then
returns ``[*B, N1, N2]``, so all heads are evaluated by one set of batched
ops instead of a ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _as_tuple(x) -> Optional[Tuple[int, ...]]:
    if x is None:
        return None
    return tuple(int(i) for i in np.asarray(x).reshape(-1))


def _take_dims(X: torch.Tensor, dims: Optional[Tuple[int, ...]]) -> torch.Tensor:
    if dims is None or list(dims) == list(range(X.shape[-1])):
        return X
    return X[..., list(dims)]


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
        """Prior mean m(X): [N] (no head axis: zero for every head)."""
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
        Xa = _take_dims(X, self.active_dims)
        if self.offset:
            Xa = torch.cat([Xa, torch.ones_like(Xa[..., :1])], dim=-1)
        return Xa

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
        return torch.prod(g, dim=-3)

    def diag(self, params, X):
        p = self.phi(X)
        diag = torch.exp(2.0 * params["log_sigma_diag"])
        g = torch.sum((p * p).unsqueeze(-3) * diag.unsqueeze(-2), dim=-1)  # [*B, degree, N]
        return torch.prod(g, dim=-2)


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
