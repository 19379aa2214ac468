"""Stacked multi-head exact GP regression on tensors.

All heads share one kernel structure; their hyperparameters are stacked
under a leading head axis G, and every operation (MLL epoch, posterior build,
prediction) runs all heads as one set of batched ops, as
``mcpilco_tpu/models/gp.py`` does with ``vmap``.  Datasets are padded to a
bucketed capacity with a validity mask (``ops/linalg.py``).

Math (as in the JAX package):
- MLL loss = 0.5 (y^T K^-1 y + log|K|), the N log 2 pi constant dropped.
- Posterior cache {alpha, F = L^-T, X_tr}: mean = m* + k*^T alpha,
  var = k**_diag - sum((k* F)^2), floored at jitter * k**_diag.  Under the
  legacy variance operator (``use_legacy_variance_op`` or
  ``MCPILCO_LEGACY_VAR=1``) the cache holds V = K^-1 instead and the quad
  term is sum((k* V) * k*): the same quantity, rounded otherwise.
- Optional per-head max-abs output normalization, applied to both the fit
  and the posterior.

Lanes: every tensor may carry leading lane axes in front of the head axis
(the seed farm's seeds, the JAX package's ``vmap`` over ``fit`` and
``posterior``): inputs x [*L, N, D], targets [*L, G, N], parameter leaves
[*L, G, ...], and the lanes' fits, posteriors and predictions are again one
set of batched ops.  Inputs get a head axis of 1 (``_hx``) before they meet
the kernel algebra, so [*L, 1, N, D] broadcasts against [*L, G, ...].

``predict`` dispatches on the device: on the card, the flagship kernel
structures run the fused CUDA kernels (``ops/fused_predict.py``), which
take the factor form; on the CPU, and under the legacy variance operator,
the plain batched ops below.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import torch

from ..ops import fused_predict as fp
from ..ops import linalg
from . import kernels as K

# The variance operator (mcpilco_tpu/models/gp.py:39-54).  Default: the
# posterior stores the factor F = L^-T and quad = sum((k* F)^2).  Legacy:
# it stores K^-1 (chol_inverse) and quad = sum((k* K^-1) * k*), the JAX
# package's round-1 form and its A/B switch.  Set MCPILCO_LEGACY_VAR=1 or
# call use_legacy_variance_op() before any posterior is built.
_LEGACY_VAR = os.environ.get("MCPILCO_LEGACY_VAR", "0") == "1"


# epochs run by MultiGP.fit and fit_sor, one per epoch (a long fit's sign of
# life for the in-process sweep's watchdog)
fit_counts = {"epochs": 0}


def use_legacy_variance_op(enable: bool = True) -> None:
    global _LEGACY_VAR
    _LEGACY_VAR = enable


def _var_operator(L, mask):
    """The posterior's variance operator from the lower factor ``L``: F =
    L^-T, or K^-1 under the legacy operator; masked rows and columns zero."""
    if _LEGACY_VAR:
        op = linalg.chol_inverse(L)
    else:
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
        op = torch.linalg.solve_triangular(L, eye, upper=False).mT
    return op * (mask[..., :, None] * mask[..., None, :])


def _quad(k_star, op):
    """sum((k* F)^2), or sum((k* K^-1) * k*) under the legacy operator."""
    kv = torch.matmul(k_star, op)
    return torch.sum(kv * (k_star if _LEGACY_VAR else kv), dim=-1)


class GPData(NamedTuple):
    """Padded training set shared across heads.

    x: [N_cap, D] inputs; y: [G, N_cap] per-head targets; mask: [N_cap]
    (each with the lane axes in front, for lanes).
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[0]


class Posterior(NamedTuple):
    """Cached posterior for rollout-time prediction.

    ``x_tr`` [M, D] is shared by all heads (per-head subsets are per-head
    ``mask`` rows).  ``var_factor`` is F = L^-T (K^-1 = F F^T), so the quad
    term is ``sum((k* F)^2)``; K^-1 itself under the legacy variance
    operator.  ``norm`` rescales to output units.
    """

    x_tr: torch.Tensor  # [M, D]
    mask: torch.Tensor  # [G, M]
    alpha: torch.Tensor  # [G, M]
    var_factor: torch.Tensor  # [G, M, M]
    norm: torch.Tensor  # [G]


class GPParams(NamedTuple):
    kernel: object  # tree, leading axis G on every leaf
    log_sigma_n: torch.Tensor  # [G]


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of same-structured trees (dict keys in
    sorted order, as JAX flattens them)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def posterior_log_likelihood(y, y_hat, var):
    """Diagonal-Gaussian negative log-likelihood of held-out targets under
    predicted means and variances (constants dropped)."""
    return torch.sum((y - y_hat) ** 2 / (2.0 * var) + 0.5 * torch.log(var))


@dataclasses.dataclass(frozen=True)
class MultiGP:
    """Static config for a stack of ``num_heads`` GPs with a shared kernel
    structure and per-head measurement noise: exact GPs, or with
    ``approx='sor'`` the Subset-of-Regressors approximation (``sor_*``)."""

    kernel: K.Kernel
    num_heads: int
    # inference mode: 'exact' (SOD subsets included) or 'sor'
    approx: str = "exact"
    # relative diagonal jitter (see mcpilco_tpu/models/gp.py:125-129)
    jitter: float = 1e-4
    train_sigma_n: bool = True
    normalize_outputs: bool = False
    # the plain predict's cross-gram k(x*, X) in column blocks of this many
    # training points, which bounds its [*L, G, P, chunk, D] difference
    # tensor (None: unchunked); K1/K2 form no such tensor and ignore it
    gram_chunk: Optional[int] = None

    # ---------------- parameter init ----------------

    def init_params(self, sigma_n=1.0, per_head_overrides=None, dtype=torch.float32,
                    device="cpu") -> GPParams:
        """Stack per-head kernel params under a leading head axis."""
        ov = per_head_overrides or [{}] * self.num_heads
        per_head = [self.kernel.init_params(dtype=dtype, device=device, **o) for o in ov]
        stacked = tree_map(lambda *xs: torch.stack(xs), *per_head)
        sn = torch.full((self.num_heads,), float(sigma_n), dtype=dtype, device=device)
        return GPParams(kernel=stacked, log_sigma_n=torch.log(sn))

    def param_mask(self, params: GPParams) -> GPParams:
        return GPParams(kernel=self.kernel.param_mask(params.kernel),
                        log_sigma_n=self.train_sigma_n)

    def scaled(self, jitter_scale: float) -> "MultiGP":
        """The same GP with its relative jitter multiplied by ``jitter_scale``."""
        return dataclasses.replace(self, jitter=self.jitter * jitter_scale)

    # ---------------- core math (all heads) ----------------

    @staticmethod
    def _hx(x):
        """Inputs [*L, N, D] with a head axis: [*L, 1, N, D]."""
        return x[..., None, :, :]

    def _head_mask(self, mask):
        """A dataset mask [*L, N] for every head: [*L, G, N]."""
        return mask[..., None, :].expand(*mask.shape[:-1], self.num_heads, mask.shape[-1])

    def _noisy_gram(self, kparams, log_sigma_n, x, mask):
        """K(x,x) + (sigma_n^2 + adaptive jitter) I: [*L, G, N, N]."""
        Kx = self.kernel.gram(kparams, self._hx(x), self._hx(x))
        jit = linalg.adaptive_jitter(Kx, mask, rel=self.jitter, floor=self.jitter)
        noise = torch.exp(2.0 * log_sigma_n) + jit
        eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
        return Kx + noise[..., None, None] * eye

    def _mean(self, kparams, x):
        """Prior mean at x [*L, N, D] for every head: [*L, G, N].  The kernel
        gives [*L, 1, N] when its mean has no per-head parameter (SE's
        constant, a zero mean) and [*L, G, N] when it has (Linear's
        ``mean_w``, a Scaled or Product of them)."""
        m = self.kernel.mean(kparams, self._hx(x))
        return m.expand(*x.shape[:-2], self.num_heads, x.shape[-2])

    def mll(self, params: GPParams, data: GPData, norm: Optional[torch.Tensor] = None):
        """Sum over heads of the negative marginal log-likelihood; per lane
        ([*L]) for lanes, as ``jax.vmap(mll)`` gives it."""
        if norm is None:
            norm = torch.ones(data.y.shape[:-1], dtype=data.x.dtype, device=data.x.device)
        mask = self._head_mask(data.mask)
        Kn = self._noisy_gram(params.kernel, params.log_sigma_n, data.x, mask)
        L = linalg.masked_cholesky(Kn, mask)
        resid = (data.y / norm[..., None] - self._mean(params.kernel, data.x)) * mask
        alpha = linalg.chol_solve(L, resid[..., None])[..., 0]
        logdet = linalg.masked_logdet_from_chol(L, mask)
        return torch.sum(0.5 * (torch.sum(resid * alpha, dim=-1) + logdet), dim=-1)

    def output_norms(self, data: GPData) -> torch.Tensor:
        """Per-head max-abs output normalizers: [*L, G]."""
        if not self.normalize_outputs:
            return torch.ones(data.y.shape[:-1], dtype=data.x.dtype, device=data.x.device)
        m = torch.amax(torch.abs(data.y) * data.mask[..., None, :], dim=-1)
        return torch.clamp(m, min=torch.finfo(data.x.dtype).tiny)

    def fit(self, params: GPParams, data: GPData, num_epochs: int, learning_rate: float = 0.01):
        """Full-batch Adam on the MLL of all heads (optax.adam semantics),
        frozen leaves held fixed, with the backtracking NaN guard of
        ``mcpilco_tpu/models/gp.py:288-333``.

        The guard runs on the device with no host sync: a step whose loss or
        update is non-finite reverts params and optimizer state to the last
        iterate whose loss evaluated finite and halves the step scale, which
        recovers by 2^(1/50) per finite epoch.  A healthy fit keeps the scale
        at exactly 1.  With lanes, the heads of all lanes take one batched
        Adam step and the guard acts per lane, as ``jax.vmap(fit)`` does: a
        non-finite epoch of one seed reverts that seed alone.

        Returns (params, loss_history [*L, num_epochs]).
        """
        norm = self.output_norms(data)
        lanes = data.x.shape[:-2]
        trainable = [bool(m) for m in _leaves(self.param_mask(params))]
        idx = [i for i, t in enumerate(trainable) if t]
        opts = dict(dtype=data.x.dtype, device=data.x.device)
        p = [l.detach().clone() for l in _leaves(params)]
        # optimizer state: Adam moments of the trainable leaves and the count
        s = ([torch.zeros_like(p[i]) for i in idx], [torch.zeros_like(p[i]) for i in idx],
             torch.zeros(lanes, **opts))
        good_p, good_s = p, s
        lr_scale = torch.ones(lanes, **opts)
        last_loss = torch.full(lanes, math.inf, **opts)
        recover = 2.0 ** (1.0 / 50.0)
        b1, b2, eps = 0.9, 0.999, 1e-8
        history = []

        def per_lane(t, leaf):
            """A per-lane value [*L] broadcast against a leaf [*L, ...]."""
            return t.reshape(t.shape + (1,) * (leaf.dim() - t.dim()))

        for _ in range(num_epochs):
            fit_counts["epochs"] += 1
            cur = [t.detach().requires_grad_(tr) for t, tr in zip(p, trainable)]
            loss = self.mll(_unflatten(params, cur), data, norm)  # [*L]
            grads = torch.autograd.grad(loss.sum(), [cur[i] for i in idx])
            with torch.no_grad():
                mu, nu, count = s
                cnt = count + 1
                mu_n = [b1 * m + (1 - b1) * g for m, g in zip(mu, grads)]
                nu_n = [b2 * v + (1 - b2) * g * g for v, g in zip(nu, grads)]
                bc1, bc2 = 1 - b1**cnt, 1 - b2**cnt
                upd = [-learning_rate * (m / per_lane(bc1, m)) / (torch.sqrt(v / per_lane(bc2, v)) + eps)
                       * per_lane(lr_scale, m) for m, v in zip(mu_n, nu_n)]
                finite = torch.isfinite(loss)
                for u in upd:
                    finite = finite & torch.all(torch.isfinite(u).flatten(len(lanes)), dim=-1)
                p_cur = [t.detach() for t in cur]
                p_new = list(p_cur)
                for j, i in enumerate(idx):
                    p_new[i] = p_cur[i] + upd[j]
                s_new = (mu_n, nu_n, cnt)

                def sel(new, old):
                    return tree_map(lambda a, b: torch.where(per_lane(finite, a), a, b), new, old)

                # finite: advance, and the current iterate becomes last-good;
                # non-finite: back to last-good params AND state
                p, s, good_p, good_s = (sel(p_new, good_p), sel(s_new, good_s),
                                        sel(p_cur, good_p), sel(s, good_s))
                lr_scale = torch.where(finite, torch.clamp(lr_scale * recover, max=1.0),
                                       lr_scale * 0.5)
                last_loss = torch.where(finite, loss, last_loss)
                history.append(last_loss)
        return _unflatten(params, p), torch.stack(history, dim=-1)

    def posterior(self, params: GPParams, x_tr, mask, y) -> Posterior:
        """Build the cached posterior (factor form F = L^-T, or K^-1).
        ``x_tr``: [*L, M, D] shared by the heads; ``mask``: [*L, G, M];
        ``y``: [*L, G, M]."""
        if self.normalize_outputs:
            norm = torch.clamp(torch.amax(torch.abs(y) * mask, dim=-1),
                               min=torch.finfo(y.dtype).tiny)
        else:
            norm = torch.ones(y.shape[:-1], dtype=y.dtype, device=y.device)
        Kn = self._noisy_gram(params.kernel, params.log_sigma_n, x_tr, mask)
        L = linalg.masked_cholesky(Kn, mask)
        resid = (y / norm[..., None] - self._mean(params.kernel, x_tr)) * mask
        alpha = linalg.chol_solve(L, resid[..., None])[..., 0] * mask
        return Posterior(x_tr=x_tr, mask=mask, alpha=alpha, var_factor=_var_operator(L, mask),
                         norm=norm)

    def fit_posterior(self, params: GPParams, data: GPData) -> Posterior:
        """Posterior over the full (shared) dataset."""
        return self.posterior(params, data.x, self._head_mask(data.mask).contiguous(), data.y)

    # ---------------- prediction ----------------

    def predict(self, params: GPParams, post: Posterior, x_star: torch.Tensor):
        """Posterior (mean, var) at ``x_star`` [P, D] for all heads: [G, P] each.

        ``x_star`` [*L, P, D] with a lane posterior (lanes in front of every
        leaf) gives [*L, G, P].  ``x_star`` [R, P, D] against a posterior
        without lanes (restart lanes, which share one posterior) is folded
        into R * P particles of one call and returns [R, G, P].  On the card,
        the 'se' and 'se+p2' structures run the fused kernels; every other
        case, every CPU tensor, and every call under the legacy variance
        operator (the kernels consume the factor form, as in the JAX
        package), runs the plain batched ops.  SOR posteriors go to
        :meth:`sor_predict` (no kernel, no lanes).
        """
        if self.approx == "sor":
            return self.sor_predict(params, post, x_star)
        fold = x_star.dim() - post.x_tr.dim()
        if fold:
            if post.x_tr.dim() != 2 or fold != 1:
                raise ValueError(f"x_star {tuple(x_star.shape)} does not match the posterior's "
                                 f"x_tr {tuple(post.x_tr.shape)}")
            return _folded(self.predict, params, post, x_star)
        if x_star.is_cuda and self._fused_structure() is not None and not _LEGACY_VAR:
            return self._predict_fused(params, post, x_star)
        return self._predict_plain(params, post, x_star)

    def _predict_plain(self, params: GPParams, post: Posterior, x_star):
        kp = params.kernel
        k_star = self._cross_gram(kp, x_star, post.x_tr) * post.mask[..., None, :]  # [*L, G, P, M]
        mean = self._mean(kp, x_star) + torch.einsum("...gpm,...gm->...gp", k_star, post.alpha)
        return self._epilogue(kp, post, x_star, mean, _quad(k_star, post.var_factor))

    def _cross_gram(self, kp, x_star, x_tr):
        """k(x*, X) [*L, G, P, M], in column blocks of ``gram_chunk`` training
        points (mcpilco_tpu/models/gp.py:194-214)."""
        c, M = self.gram_chunk, x_tr.shape[-2]
        hs = self._hx(x_star)
        if c is None or M <= c:
            return self.kernel.gram(kp, hs, self._hx(x_tr))
        return torch.cat([self.kernel.gram(kp, hs, self._hx(x_tr[..., j:j + c, :]))
                          for j in range(0, M, c)], dim=-1)

    def _epilogue(self, kp, post: Posterior, x_star, mean, quad):
        # floor at jitter * prior diag, not 0: near interpolation the true
        # variance is ~0 and d(sqrt(var))/d(var) would amplify fp32 roundoff
        # in BPTT (mcpilco_tpu/models/gp.py:230-236)
        diag = self.kernel.diag(kp, self._hx(x_star)).expand_as(quad)
        var = torch.maximum(diag - quad, self.jitter * diag)
        return mean * post.norm[..., None], var * (post.norm**2)[..., None]

    def _fused_structure(self):
        """'se' | 'se+p2' | None: does the kernel match a fused structure
        (full active_dims in identity order)?"""

        def full_dims(kk):
            return kk.active_dims is not None and list(kk.active_dims) == list(
                range(len(kk.active_dims))
            )

        k = self.kernel
        if isinstance(k, K.SEArd) and full_dims(k):
            return "se"
        if (
            isinstance(k, K.Sum)
            and len(k.members) == 3
            and isinstance(k.members[0], K.SEArd)
            and isinstance(k.members[1], K.MPK)
            and isinstance(k.members[2], K.MPK)
            and k.members[1].degree == 1
            and k.members[1].offset
            and k.members[2].degree == 2
            and not k.members[2].offset
            and all(full_dims(m) for m in k.members)
        ):
            return "se+p2"
        return None

    def _predict_fused(self, params: GPParams, post: Posterior, x_star):
        """Predict through :class:`~..ops.fused_predict.GramContract`, then
        add the prior mean, take diag - quad, floor and rescale."""
        if _LEGACY_VAR:
            raise ValueError("K1/K2 take the factor form F = L^-T; under the legacy variance "
                             "operator the posterior holds K^-1 (use _predict_plain)")
        structure = self._fused_structure()
        kp = params.kernel
        dt, dev = x_star.dtype, x_star.device
        if structure == "se":
            se = kp
            heads = se["log_lengthscales"].shape[:-1]  # [*L, G]
            d = se["log_lengthscales"].shape[-1]
            poly1 = torch.zeros((*heads, d + 1), dtype=dt, device=dev)
            poly2a = torch.zeros((*heads, d), dtype=dt, device=dev)
            poly2b = torch.zeros((*heads, d), dtype=dt, device=dev)
        else:
            se = kp[0]
            heads = se["log_lengthscales"].shape[:-1]
            poly1 = torch.exp(2.0 * kp[1]["log_sigma_diag"][..., 0, :])
            poly2a = torch.exp(2.0 * kp[2]["log_sigma_diag"][..., 0, :])
            poly2b = torch.exp(2.0 * kp[2]["log_sigma_diag"][..., 1, :])
        se_w = torch.exp(-2.0 * se["log_lengthscales"])
        se_lam = torch.exp(se["log_lambda"]).reshape(heads)
        kalpha, quad = fp.gram_contract(
            se_w, se_lam, poly1, poly2a, poly2b, x_star, post.x_tr, post.alpha,
            post.var_factor, post.mask, structure == "se+p2",
        )
        mean = self._mean(kp, x_star) + kalpha
        return self._epilogue(kp, post, x_star, mean, quad)

    # ---------------- Subset-of-Regressors approximation ----------------
    # SOR replaces k(x, x') by k(x, U) K_UU^-1 k(U, x') for an inducing set U
    # (mcpilco_tpu/models/gp.py:439-636).  Its posterior reuses Posterior:
    # x_tr = U ([N, D] rows of the data, or trained per-head [G, M, D]),
    # mask = the selection [G, M], alpha = the SOR coefficients and
    # var_factor = F with Sigma = (K_UU + sigma_n^-2 K_UX K_XU)^-1 = F F^T
    # (Sigma itself under the legacy variance operator);
    #     mean* = m* + k(*, U) alpha,   var* = sum((k(*, U) F)^2),
    # floored at jitter * k**_diag.  The variance is the quad term itself,
    # not diag - quad, so SOR has its own predict.  No lane axis: the seed
    # farm refuses SOR.

    def _noise_var(self, log_sigma_n):
        return torch.exp(2.0 * log_sigma_n) + self.jitter

    def _hu(self, u):
        """Inducing inputs with a head axis: shared [M, D] as [1, M, D], or
        per head [G, M, D] as they are."""
        return u if u.dim() == 3 else self._hx(u)

    def _sor_cross(self, kp, data: GPData, hu, sel):
        """K_XU [G, N, M] masked by the data and the selection."""
        K_xu = self.kernel.gram(kp, self._hx(data.x), hu)
        return K_xu * (data.mask[:, None] * sel[..., None, :])

    def _resid(self, kp, data: GPData, norm):
        return (data.y / norm[..., None] - self._mean(kp, data.x)) * data.mask

    def sor_posterior(self, params: GPParams, data: GPData, sel, u=None) -> Posterior:
        """The SOR posterior: ``sel`` [G, M] marks valid inducing rows; ``u``
        [G, M, D] overrides the inducing inputs (default: the rows of
        ``data.x``, M = N)."""
        kp = params.kernel
        norm = self.output_norms(data)
        noise = self._noise_var(params.log_sigma_n)[:, None, None]
        hu = self._hu(data.x if u is None else u)
        m2 = sel[..., :, None] * sel[..., None, :]
        K_xu = self._sor_cross(kp, data, hu, sel)
        sigma_inv = self.kernel.gram(kp, hu, hu) * m2 + (K_xu.mT @ K_xu) / noise
        # the jitter tracks sigma_inv's own scale (~ sigma_n^-2 N k^2)
        jit = linalg.adaptive_jitter(sigma_inv, sel, rel=self.jitter, floor=self.jitter)
        sigma_inv = sigma_inv + jit[:, None, None] * torch.diag_embed(sel)
        L = linalg.masked_cholesky(sigma_inv, sel)
        F = _var_operator(L, sel)
        rhs = K_xu.mT @ self._resid(kp, data, norm)[..., None]
        alpha = linalg.chol_solve(L, rhs)[..., 0] / noise[..., 0]
        return Posterior(x_tr=data.x if u is None else u, mask=sel, alpha=alpha * sel,
                         var_factor=F, norm=norm)

    def sor_mll(self, params: GPParams, data: GPData, sel, u=None, norm=None):
        """Sum over heads of the negative SOR (Nystrom) marginal
        log-likelihood, in whitened form: with K_UU = L L^T, B = L^-1 K_UX
        and A = I + B B^T / s2,
            log|K_sor| = N log s2 + log|A|,
            y^T K_sor^-1 y = |y|^2 / s2 - (By)^T A^-1 (By) / s2^2.
        Equals :meth:`mll` when the inducing set is the whole dataset."""
        kp = params.kernel
        if norm is None:
            norm = self.output_norms(data)
        noise = self._noise_var(params.log_sigma_n)
        hu = self._hu(data.x if u is None else u)
        m = hu.shape[-2]
        eye = torch.eye(m, dtype=data.x.dtype, device=data.x.device)
        K_uu = self.kernel.gram(kp, hu, hu).expand(self.num_heads, m, m)
        jit = linalg.adaptive_jitter(K_uu, sel, rel=self.jitter, floor=self.jitter)
        L_uu = linalg.masked_cholesky(K_uu + jit[:, None, None] * eye, sel)
        B = torch.linalg.solve_triangular(L_uu, self._sor_cross(kp, data, hu, sel).mT,
                                          upper=False)  # [G, M, N]
        # A's unselected rows are identity rows, so the masked factor is A's own
        L_a = linalg.masked_cholesky(eye + (B @ B.mT) / noise[:, None, None], sel)
        logdet_a = linalg.masked_logdet_from_chol(L_a, sel)
        resid = self._resid(kp, data, norm)
        b = (B @ resid[..., None])[..., 0]
        w = linalg.chol_solve(L_a, b[..., None])[..., 0]
        quad = (torch.sum(resid * resid, dim=-1) / noise
                - torch.sum(b * w, dim=-1) / (noise * noise))
        logdet = torch.sum(data.mask) * torch.log(noise) + logdet_a
        return torch.sum(0.5 * (quad + logdet))

    def fit_sor(self, params: GPParams, data: GPData, sel, num_epochs: int,
                learning_rate: float = 0.01, train_inducing: bool = False, u=None):
        """Full-batch Adam (optax.adam semantics) on :meth:`sor_mll`, frozen
        leaves held fixed; with ``train_inducing`` the inducing inputs ``u``
        (default: ``data.x`` copied per head) train too.  A step whose loss
        is non-finite keeps the last iterate and optimizer state
        (mcpilco_tpu/models/gp.py:601-611; not the exact fit's backtracking).

        Returns (params, u [G, M, D], loss_history [num_epochs]).
        """
        norm = self.output_norms(data)
        if u is None:
            u = data.x.expand(self.num_heads, *data.x.shape)
        leaves = [l.detach().clone() for l in _leaves(params)] + [u.detach().clone()]
        trainable = [bool(m) for m in _leaves(self.param_mask(params))] + [bool(train_inducing)]
        idx = [i for i, t in enumerate(trainable) if t]
        mu = [torch.zeros_like(leaves[i]) for i in idx]
        nu = [torch.zeros_like(leaves[i]) for i in idx]
        b1, b2, eps = 0.9, 0.999, 1e-8
        opts = dict(dtype=data.x.dtype, device=data.x.device)
        count, last = torch.zeros((), **opts), torch.tensor(math.inf, **opts)
        history = []
        for _ in range(num_epochs):
            fit_counts["epochs"] += 1
            cur = [t.detach().requires_grad_(tr) for t, tr in zip(leaves, trainable)]
            loss = self.sor_mll(_unflatten(params, cur[:-1]), data, sel, u=cur[-1], norm=norm)
            grads = torch.autograd.grad(loss, [cur[i] for i in idx])
            with torch.no_grad():
                finite = torch.isfinite(loss)
                cnt = count + 1
                bc1, bc2 = 1 - b1**cnt, 1 - b2**cnt
                for j, (i, g) in enumerate(zip(idx, grads)):
                    m_new = b1 * mu[j] + (1 - b1) * g
                    v_new = b2 * nu[j] + (1 - b2) * g * g
                    upd = -learning_rate * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                    leaves[i] = torch.where(finite, cur[i].detach() + upd, cur[i].detach())
                    mu[j] = torch.where(finite, m_new, mu[j])
                    nu[j] = torch.where(finite, v_new, nu[j])
                count = torch.where(finite, cnt, count)
                last = torch.where(finite, loss, last)
                history.append(last)
        return _unflatten(params, leaves[:-1]), leaves[-1], torch.stack(history)

    def sor_predict(self, params: GPParams, post: Posterior, x_star):
        """SOR (mean, var) at ``x_star`` [P, D]: [G, P] each, for a shared
        ``post.x_tr`` [M, D] or per-head inducing inputs [G, M, D].  Restart
        lanes' ``x_star`` [R, P, D] fold into R * P particles: [R, G, P]."""
        if x_star.dim() == 3:
            return _folded(self.sor_predict, params, post, x_star)
        kp = params.kernel
        k_star = self.kernel.gram(kp, self._hx(x_star), self._hu(post.x_tr))
        k_star = k_star * post.mask[..., None, :]
        mean = self._mean(kp, x_star) + torch.einsum("gpm,gm->gp", k_star, post.alpha)
        diag = self.kernel.diag(kp, self._hx(x_star)).expand(self.num_heads, x_star.shape[-2])
        var = torch.maximum(_quad(k_star, post.var_factor), self.jitter * diag)
        return mean * post.norm[:, None], var * (post.norm**2)[:, None]


def _folded(predict, params, post, x_star):
    """``predict`` of x* [R, P, D] against one posterior (restart lanes) as
    one call on R * P particles: (mean, var) [R, G, P]."""
    R, P, D = x_star.shape
    mean, var = predict(params, post, x_star.reshape(R * P, D))
    unfold = lambda t: t.reshape(-1, R, P).transpose(0, 1)
    return unfold(mean), unfold(var)


def _unflatten(structure, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def first_finite(posteriors):
    """Per lane, the first posterior of ``posteriors`` whose every leaf is
    finite, else the last one (the escalation of
    ``mcpilco_tpu/parallel/multiseed.py:318-355``, without a host sync).
    The posteriors have lanes [L] in front of every leaf and equal shapes."""

    def finite(post):
        return torch.stack([torch.isfinite(t).flatten(1).all(-1) for t in post]).all(0)  # [L]

    out = posteriors[-1]
    for post in reversed(posteriors[:-1]):
        ok = finite(post)
        out = Posterior(*(torch.where(ok.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                          for a, b in zip(post, out)))
    return out
