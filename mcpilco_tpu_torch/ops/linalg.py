"""Masked dense linear algebra for padded GP datasets.

Datasets are stored padded to a bucketed capacity with a validity mask, as
in ``mcpilco_tpu/ops/linalg.py``: masked rows and columns of a Gram matrix
become identity rows, so the padded factor embeds the valid block's factor,
adds nothing to the log-determinant and gives zero ``alpha`` on padding.
Every function takes an optional leading batch (head) axis.
"""

from __future__ import annotations

import torch


def bucket_size(n: int, bucket: int = 64, minimum: int = 64) -> int:
    """Round ``n`` up to a shape bucket."""
    if n <= minimum:
        return minimum
    return ((n + bucket - 1) // bucket) * bucket


def mask_gram(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace masked rows/cols of a square Gram matrix with identity rows."""
    m2 = mask[..., :, None] * mask[..., None, :]
    return K * m2 + torch.diag_embed((1.0 - mask).to(K.dtype))


def masked_cholesky(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the masked Gram matrix, NaN where not PD.

    JAX returns NaN for a matrix that is not positive definite, while
    ``torch.linalg.cholesky`` raises.  The MLL backtracking guard and the
    posterior's jitter escalation both read that NaN, so the failed factors
    are filled with NaN here.
    """
    L, info = torch.linalg.cholesky_ex(mask_gram(K, mask))
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``K x = B`` given the lower Cholesky factor ``L`` of K."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def chol_inverse(L: torch.Tensor) -> torch.Tensor:
    """Dense inverse of K from its lower Cholesky factor ``L``: the legacy
    variance operator's posterior stores it (``models/gp.py``)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return chol_solve(L, eye)


def masked_logdet_from_chol(L: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log|K_valid| from the masked Cholesky factor (masked rows give log 1)."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    tiny = torch.finfo(L.dtype).tiny
    return 2.0 * torch.sum(torch.log(torch.clamp(d, min=tiny)) * mask, dim=-1)


def adaptive_jitter(K: torch.Tensor, mask: torch.Tensor, rel: float = 1e-6,
                    floor: float = 1e-6) -> torch.Tensor:
    """Jitter scaled to the Gram magnitude: ``max(rel * mean valid diag, floor)``."""
    n_valid = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    tr = torch.sum(torch.diagonal(K, dim1=-2, dim2=-1) * mask, dim=-1) / n_valid
    return torch.clamp(rel * tr, min=floor)
