"""Fused multi-head GP posterior prediction: two CUDA kernels and their plain twins.

The rollout evaluates, per scan step and per GP head,

    k* = k(x*, X_tr)            (SE-ARD, optionally + Volterra-MPK(2))
    kalpha = k* @ alpha
    quad   = sum((k* @ F)^2, -1)      (F = Posterior.var_factor)

``csrc/fused_predict.cu`` computes this chain in one kernel per call (K1)
and x*'s cotangent in a second (K2); they replace the Pallas kernels
``fused_gram_contract`` and ``fused_gram_contract_bwd_xstar`` of
``mcpilco_tpu/ops/fused_predict.py``.  When x* needs a gradient, K1 also
returns kF = k* @ F, which K2 consumes in place of recomputing it.  Above
8 input dims K1 is two kernels: a generation pass (``k1_gen``; alone:
:func:`fused_gram_gen`, plain twin :func:`reference_gram_gen`) writes the
masked k* once per call, then a GEMM takes it; :func:`wide_plan` picks the
wide kernels' tiles per shape.
:class:`GramContract` is the autograd function around them.  On a CUDA
tensor it launches the kernels or raises; on a CPU tensor it uses their
plain PyTorch versions, :func:`reference_gram_contract` and
:func:`reference_gram_contract_bwd_xstar`, which are also the oracles the
kernels are held against on the card.

Every function takes an optional leading lane axis L on all of its
arguments (one posterior per seed of the seed farm, the JAX package's
``vmap`` over seeds): x_star [L, P, D], x_tr [L, M, D], se_w [L, G, D], ...,
and returns [L, G, P] / [L, P, D].  Without it, the inputs are one lane.

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
MAX_D = 32  # input dims the kernels take (csrc MAX_D)
NARROW_D = 8  # up to here the narrow kernels; above, the wide path (csrc NARROW_D)
# the wide path's tiles (csrc GEN_*, WIDE_K1_CONFIGS, WIDE_K2_CONFIGS):
# k1_gen's (particles, training points) per block; per configuration of
# k1_forward_wide (particles, columns of F, slices) and of
# k2_backward_xstar_wide (particles, training points, slices, blocks per SM
# its registers leave room for), largest first.  K2's configurations sum in
# the same order: their results are bitwise equal.
GEN_TILE = (32, 64)
WIDE_K1 = ((64, 64, 1), (32, 64, 2), (16, 32, 4))
WIDE_K2 = ((32, 32, 2, 4), (32, 32, 2, 5), (32, 32, 2, 6), (16, 32, 2, 5))
SMS = 132  # the H100's streaming multiprocessors

# Kernel launches by the wrappers below, one per launch, and the lanes those
# launches carried (L per launch); launches recorded into a CUDA graph count
# once per replay (CapturedLaunches).
launches = {"fwd": 0, "bwd": 0}
launched_lanes = {"fwd": 0, "bwd": 0}
# launches of the wide path's generation kernel (k1_gen): one per K1 launch
# above 8 input dims, and one per fused_gram_gen
gen_launches = {"gen": 0}
_COUNTS = (launches, launched_lanes, gen_launches)


def reset_launches() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


class CapturedLaunches:
    """The launches a CUDA-graph capture records.  The wrappers count a
    call when it is made, and a call made while a stream captures launches
    nothing then: around the capture, this takes those calls back out of
    the counts, and :meth:`replay` adds them once per replay of the graph."""

    def __enter__(self):
        self._before = tuple(dict(c) for c in _COUNTS)
        return self

    def __exit__(self, *exc):
        self.counts = [{k: now[k] - was[k] for k in now}
                       for now, was in zip(_COUNTS, self._before)]
        for counts, was in zip(_COUNTS, self._before):
            counts.update(was)
        return False

    def replay(self) -> None:
        for counts, add in zip(_COUNTS, self.counts):
            for k, n in add.items():
                counts[k] += n

_lib = None
_tiles = None  # (K1 particles, K1 columns of F, K2 particles, K2 training points) per block


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build(source=SOURCE):
    """Compile the kernels of ``source`` (this checkout's by default) unless
    that source is already built.

    Returns ``(path of the shared library, compiler log)``; the log holds
    ``ptxas``'s register and shared-memory report when a build ran.
    """
    source = Path(source)
    src = source.read_bytes()
    out = BUILD_DIR / f"libfused_predict_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def bind(path):
    """Load a built library and make it the one the wrappers launch; one
    whose wide tiles are not :func:`wide_plan`'s is refused."""
    global _lib, _tiles
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fp_forward.argtypes = [ptr] * 16 + [i32] * 8 + [ptr]
    lib.fp_forward.restype = i32
    lib.fp_gen.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
    lib.fp_gen.restype = i32
    lib.fp_backward_xstar.argtypes = [ptr] * 15 + [i32] * 8 + [ptr]
    lib.fp_backward_xstar.restype = i32
    lib.fp_error_string.argtypes = [i32]
    lib.fp_error_string.restype = ctypes.c_char_p
    lib.fp_tiles.argtypes = [ptr, i32]
    lib.fp_tiles.restype = i32
    tiles = (ctypes.c_int * 64)()
    n = lib.fp_tiles(tiles, len(tiles))
    want = [*GEN_TILE, len(WIDE_K1), *(v for t in WIDE_K1 for v in t), len(WIDE_K2),
            *(v for t in WIDE_K2 for v in t)]
    if list(tiles[4:n]) != want:
        raise RuntimeError(f"{path}: the library's wide tiles {list(tiles[4:n])} are not the "
                           f"plan's {want}")
    _lib, _tiles = lib, tuple(tiles[:4])
    return lib


def _library():
    if _lib is None:
        bind(build()[0])
    return _lib


def _grid(G, P, M, L, bp, bn):
    return L * G * -(-P // bp) * -(-M // bn)


def _pick(tiles, G, P, M, L):
    """The index of the first (largest) tile whose grid runs at least 1.5
    waves of blocks on the card's SMs; else of the one with the most blocks
    that stays within one wave; else the last."""
    blocks = [_grid(G, P, M, L, bp, bn) for bp, bn, *_ in tiles]
    full = [i for i, b in enumerate(blocks) if b >= 1.5 * SMS]
    if full:
        return full[0]
    within = [i for i, b in enumerate(blocks) if b <= SMS]
    return max(within, key=lambda i: blocks[i]) if within else len(tiles) - 1


def wide_plan(G: int, P: int, M: int, L: int = 1):
    """The wide path's launches at these shapes (pure Python; the C side
    takes the configuration indices): per kernel its configuration, tile
    and blocks per launch over L lanes, and the padded particle count Pp of
    k*'s layout.  A lane's bits must not depend on L: K1's configurations
    sum in different orders, so one lane's shape picks K1's; K2's all sum
    alike, so all L lanes' blocks pick its tile, and then the fewest blocks
    per SM (the most registers) that hold its grid at once."""
    k1 = _pick(WIDE_K1, G, P, M, 1)
    bp, bm = WIDE_K2[_pick(WIDE_K2, G, P, M, L)][:2]
    tile = [i for i, t in enumerate(WIDE_K2) if t[:2] == (bp, bm)]
    blocks = _grid(G, P, M, L, bp, bm)
    k2 = next((i for i in tile if blocks <= WIDE_K2[i][3] * SMS), tile[-1])
    return {
        "Pp": -(-P // GEN_TILE[0]) * GEN_TILE[0],
        "k1_gen": dict(tile=GEN_TILE, blocks=_grid(G, P, M, L, *GEN_TILE)),
        "k1_forward_wide": dict(config=k1, tile=WIDE_K1[k1],
                                blocks=_grid(G, P, M, L, *WIDE_K1[k1][:2])),
        "k2_backward_xstar_wide": dict(config=k2, tile=WIDE_K2[k2],
                                       blocks=_grid(G, P, M, L, *WIDE_K2[k2][:2])),
    }


def launch_blocks(G: int, P: int, M: int, L: int = 1, D: int = 6):
    """Blocks per launch of (K1, K2) at these shapes, over L lanes; above 8
    input dims K1's GEMM (its generation pass: :func:`wide_plan`)."""
    if D > NARROW_D:
        plan = wide_plan(G, P, M, L)
        return plan["k1_forward_wide"]["blocks"], plan["k2_backward_xstar_wide"]["blocks"]
    _library()
    k1_bp, k1_bn, k2_bp, k2_bm = _tiles
    return _grid(G, P, M, L, k1_bp, k1_bn), _grid(G, P, M, L, k2_bp, k2_bm)


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fp_error_string(err).decode()} ({err})")


_ARG_NAMES = ("se_w", "se_lam", "poly1", "poly2a", "poly2b", "x_star", "x_tr", "alpha",
              "var_factor", "mask", "kf", "g1", "g2")


def _validate(tensors, shapes, device, names=_ARG_NAMES):
    if device.type != "cuda":
        raise ValueError(f"the kernels run on a CUDA device, got {device}")
    for name, t, shape in zip(names, tensors, shapes):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous float32 tensors on {device}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _shapes(se_w, x_star, x_tr):
    L, G, D = se_w.shape
    P, M = x_star.shape[1], x_tr.shape[1]
    if P == 0 or M == 0:
        raise ValueError("the kernels need at least one particle and one training point")
    if D > MAX_D:
        raise ValueError(f"the kernels take at most {MAX_D} input dims, got {D}")
    if L * G > 65535:
        raise ValueError(f"the kernels take at most 65535 (lane, head) pairs, got {L * G}")
    shapes = [(G, D), (G,), (G, D + 1), (G, D), (G, D), (P, D), (M, D), (G, M), (G, M, M),
              (G, M), (G, P, M), (G, P), (G, P)]
    return L, G, P, M, D, [(L, *s) for s in shapes]


def _as_lanes(tensors):
    """(lane-batched tensors, whether the caller gave one lane without the
    axis): x_star [P, D] marks a call without a lane axis."""
    one = tensors[5].dim() == 2
    return [t.unsqueeze(0) for t in tensors] if one else list(tensors), one


def _vec(M, *tensors) -> int:
    """1 when F's and kF's rows can be copied 16 bytes at a time: M % 4 == 0
    makes every row, head and lane stride (M, M^2, P M floats) a multiple of
    4 floats, so 16-byte-aligned base pointers keep every row aligned."""
    return int(M % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def _stream(device):
    # read at every launch: under a capture it is the capturing stream,
    # which is what records K1/K2 into the graph
    return torch.cuda.current_stream(device).cuda_stream


def fused_gram_contract(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor,
                        mask, use_poly: bool, return_kf: bool = False):
    """K1 on the card: returns (kalpha [G, P], quad [G, P]), and kF [G, P, M]
    too when ``return_kf``; each with the lane axis in front when the
    inputs have one.

    se_w [G, D] inverse squared lengthscales; se_lam [G] outputscales;
    poly1 [G, D+1], poly2a/b [G, D]; x_star [P, D]; x_tr [M, D];
    alpha [G, M]; var_factor [G, M, M] (F); mask [G, M].  The kernel writes
    quad's partial sums per tile of F's columns, and a second kernel sums
    them in a fixed order.
    """
    args, one = _as_lanes((se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                           var_factor, mask))
    L, G, P, M, D, shapes = _shapes(args[0], args[5], args[6])
    dev = x_star.device
    _validate(args, shapes, dev)
    lib = _library()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    kalpha, quad = new(L, G, P), new(L, G, P)
    kf = new(L, G, P, M) if return_kf else None
    ptr = lambda t: None if t is None else t.data_ptr()
    vec = _vec(M, args[8], kf)
    if D > NARROW_D:
        # the generation pass's k* [L, G, M, Pp] and kalpha's partials per
        # point tile; quad's partials per column tile of the plan's GEMM
        plan = wide_plan(G, P, M)
        cfg = plan["k1_forward_wide"]["config"]
        kt, kapart = new(L, G, M, plan["Pp"]), new(L, G, -(-M // GEN_TILE[1]), P)
        qpart = new(L, G, -(-M // WIDE_K1[cfg][1]), P)
        err = lib.fp_forward(*(t.data_ptr() for t in args), kalpha.data_ptr(), qpart.data_ptr(),
                             quad.data_ptr(), ptr(kf), kt.data_ptr(), kapart.data_ptr(), L, G, P,
                             M, D, int(bool(use_poly)), vec, cfg, _stream(dev))
    else:
        qpart = new(L, G, -(-M // _tiles[1]), P)
        err = lib.fp_forward(*(t.data_ptr() for t in args), kalpha.data_ptr(), qpart.data_ptr(),
                             quad.data_ptr(), ptr(kf), None, None, L, G, P, M, D,
                             int(bool(use_poly)), vec, 0, _stream(dev))
    _check_launch(lib, err, "fp_forward")
    launches["fwd"] += 1
    launched_lanes["fwd"] += L
    if D > NARROW_D:
        gen_launches["gen"] += 1
    out = (kalpha, quad, kf) if return_kf else (kalpha, quad)
    return tuple(t[0] for t in out) if one else out


def fused_gram_contract_bwd_xstar(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                                  var_factor, mask, kf, g1, g2, use_poly: bool):
    """K2 on the card: d(loss)/d(x_star) [P, D] for cotangents g1, g2 [G, P]
    of (kalpha, quad), from K1's kF [G, P, M]; lane axis in front as in
    :func:`fused_gram_contract`.  The kernel writes partials per head and
    per tile of training points; a second kernel sums them in a fixed
    order."""
    args, one = _as_lanes((se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                           var_factor, mask, kf, g1, g2))
    L, G, P, M, D, shapes = _shapes(args[0], args[5], args[6])
    dev = x_star.device
    _validate(args, shapes, dev)
    lib = _library()
    bm, cfg = _tiles[3], 0
    if D > NARROW_D:
        k2 = wide_plan(G, P, M, L)["k2_backward_xstar_wide"]
        bm, cfg = k2["tile"][1], k2["config"]
    dxp = torch.empty((L, G, -(-M // bm), P, D), dtype=torch.float32, device=dev)
    dx = torch.empty((L, P, D), dtype=torch.float32, device=dev)
    err = lib.fp_backward_xstar(
        *(t.data_ptr() for t in args), dxp.data_ptr(), dx.data_ptr(), L, G, P, M, D,
        int(bool(use_poly)), _vec(M, args[8], args[10]), cfg, _stream(dev),
    )
    _check_launch(lib, err, "fp_backward_xstar")
    launches["bwd"] += 1
    launched_lanes["bwd"] += L
    return dx[0] if one else dx


def fused_gram_gen(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, mask,
                   use_poly: bool):
    """The wide path's generation kernel alone on the card (``k1_gen``, then
    the sum of kalpha's partials): returns (k* [G, P, M], kalpha [G, P]),
    with the lane axis in front when the inputs have one; k* is a view of
    the kernel's [M, Pp] layout.  Any D up to 32.  K1 launches the same
    kernel above 8 input dims; this wrapper serves its check against
    :func:`reference_gram_gen`."""
    args, one = _as_lanes((se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, mask))
    L, G, P, M, D, shapes = _shapes(args[0], args[5], args[6])
    dev = x_star.device
    _validate(args, shapes[:8] + shapes[9:10], dev, _ARG_NAMES[:8] + _ARG_NAMES[9:10])
    lib = _library()
    Pp = wide_plan(G, P, M)["Pp"]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    kt, kapart, kalpha = new(L, G, M, Pp), new(L, G, -(-M // GEN_TILE[1]), P), new(L, G, P)
    err = lib.fp_gen(*(t.data_ptr() for t in args), kt.data_ptr(), kapart.data_ptr(),
                     kalpha.data_ptr(), L, G, P, M, D, int(bool(use_poly)), _stream(dev))
    _check_launch(lib, err, "fp_gen")
    gen_launches["gen"] += 1
    k = kt[..., :P].transpose(-1, -2)
    return (k[0], kalpha[0]) if one else (k, kalpha)


def _gram_terms(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, use_poly):
    """k_se [..., G, P, M] and, in 'se+p2', the polynomial terms (lin1, a2, b2)."""
    diff = x_star[..., :, None, :] - x_tr[..., None, :, :]  # [..., P, M, D]
    d = torch.einsum("...pmd,...gd->...gpm", diff * diff, se_w)
    k_se = se_lam[..., None, None] * torch.exp(-d)
    if not use_poly:
        return k_se, None
    lin1 = (torch.einsum("...pd,...gd,...md->...gpm", x_star, poly1[..., :-1], x_tr)
            + poly1[..., -1:, None])
    a2 = torch.einsum("...pd,...gd,...md->...gpm", x_star, poly2a, x_tr)
    b2 = torch.einsum("...pd,...gd,...md->...gpm", x_star, poly2b, x_tr)
    return k_se, (lin1, a2, b2)


def reference_gram_gen(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, mask,
                       use_poly: bool):
    """Plain PyTorch version of the generation kernel ``k1_gen``: the masked
    k* [..., G, P, M] and kalpha = k* alpha [..., G, P] (same optional lane
    axis); its oracle on the card, and the first half of
    :func:`reference_gram_contract`."""
    k, poly = _gram_terms(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, use_poly)
    if poly is not None:
        lin1, a2, b2 = poly
        k = k + lin1 + a2 * b2
    k = k * mask[..., None, :]
    return k, torch.einsum("...gpm,...gm->...gp", k, alpha)


def reference_gram_contract(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                            var_factor, mask, use_poly: bool, return_kf: bool = False):
    """Plain PyTorch version of K1 (same formulas, same optional lane axis):
    the CPU path, the source of every gradient but x*'s, and K1's oracle on
    the card."""
    k, kalpha = reference_gram_gen(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                                   mask, use_poly)
    kf = torch.matmul(k, var_factor)
    quad = torch.sum(kf * kf, dim=-1)
    return (kalpha, quad, kf) if return_kf else (kalpha, quad)


def reference_gram_contract_bwd_xstar(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                                      var_factor, mask, kf, g1, g2, use_poly: bool):
    """Plain PyTorch version of K2: d(loss)/d(x_star) [P, D] from kF [G, P, M]
    and the cotangents g1, g2 [G, P] of (kalpha, quad), with the optional
    lane axis in front.  The formulas of the TPU kernel's body
    (``_make_bwd_body``, mcpilco_tpu/ops/fused_predict.py) with kF given
    instead of recomputed; K2's oracle on the card."""
    k_se, poly = _gram_terms(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, use_poly)
    xs, xt = x_star[..., None, :, :], x_tr[..., None, :, :]  # a head axis
    kf_ft = torch.matmul(kf, var_factor.mT)  # [..., G, P, M]
    kbar = (g1[..., None] * alpha[..., None, :] + 2.0 * g2[..., None] * kf_ft) * mask[..., None, :]
    dbar = -kbar * k_se  # cotangent of the squared distance
    dx = 2.0 * se_w[..., None, :] * (xs * dbar.sum(-1, keepdim=True) - dbar @ xt)
    if poly is not None:
        _, a2, b2 = poly
        dx = (dx + poly1[..., None, :-1] * (kbar @ xt) + poly2a[..., None, :] * ((kbar * b2) @ xt)
              + poly2b[..., None, :] * ((kbar * a2) @ xt))
    return dx.sum(dim=-3)


def _prep(t):
    return t.detach().to(torch.float32).contiguous()


class GramContract(torch.autograd.Function):
    """(kalpha, quad) of the fused contraction, differentiable.

    x*'s cotangent comes from K2 on the card (its plain version on the CPU)
    and reuses the kF that the forward saved when ``save_kf``.  Every other
    input's cotangent comes from the plain K1, and only when
    ``ctx.needs_input_grad`` asks for it: in the policy loop the posterior
    and hyperparameters are constants, so only K1 and K2 run.
    """

    @staticmethod
    def forward(ctx, se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor,
                mask, use_poly, save_kf):
        args = (se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor, mask)
        ctx.use_poly = use_poly
        if x_star.is_cuda:
            out = fused_gram_contract(*(_prep(t) for t in args), use_poly, save_kf)
        else:
            out = reference_gram_contract(*args, use_poly, save_kf)
        ctx.save_for_backward(*args, out[2] if save_kf else None)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, g_kalpha, g_quad):
        *args, kf = ctx.saved_tensors
        x_star = args[5]
        zeros = x_star.new_zeros(args[0].shape[:-1] + x_star.shape[-2:-1])  # [..., G, P]
        g1 = zeros if g_kalpha is None else g_kalpha
        g2 = zeros if g_quad is None else g_quad
        grads = [None] * len(args)
        needs = list(ctx.needs_input_grad[: len(args)])
        if needs[5]:  # then x* required grad under grad mode, and the forward saved kF
            if x_star.is_cuda:
                grads[5] = fused_gram_contract_bwd_xstar(
                    *(_prep(t) for t in (*args, kf, g1, g2)), ctx.use_poly
                ).to(x_star.dtype)
            else:
                grads[5] = reference_gram_contract_bwd_xstar(*args, kf, g1, g2, ctx.use_poly)
            needs[5] = False
        wanted = [i for i, n in enumerate(needs) if n]
        if wanted:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(args)]
                # quad does not depend on alpha: pass on only the outputs
                # that reach a wanted input
                out = [(o, g) for o, g in zip(reference_gram_contract(*leaves, ctx.use_poly),
                                               (g1, g2)) if o.requires_grad]
                got = torch.autograd.grad([o for o, _ in out], [leaves[i] for i in wanted],
                                          [g for _, g in out], allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (*grads, None, None)


def gram_contract(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha, var_factor, mask,
                  use_poly: bool):
    save_kf = torch.is_grad_enabled() and x_star.requires_grad
    return GramContract.apply(se_w, se_lam, poly1, poly2a, poly2b, x_star, x_tr, alpha,
                              var_factor, mask, use_poly, save_kf)


# the kernels' tolerances against their plain versions (those of the JAX
# package's tests/test_fused_predict.py:32 and :65)
FWD_TOL = dict(rtol=2e-5, atol=1e-5)  # kalpha, quad; mean and variance
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # dx*


def k1_work(L, P, M, use_poly, G, D):
    """(bytes, flops) of K1 as the main path calls it (kF saved): every
    input read once, every output written once; flops of the kF
    contraction, kalpha, quad and the k generation (distance, exp, mask and
    the polynomial terms over the D input dims, an FMA counted as 2)."""
    inputs = G * D + G + G * (D + 1) + 2 * G * D + P * D + M * D + G * M + G * M * M + G * M
    outputs = 2 * G * P + G * P * M
    gen = 4 * D + 4 + (6 * D + 3 if use_poly else 0)
    return 4 * L * (inputs + outputs), L * G * P * M * (2 * M + 4 + gen)


def gen_work(L, P, M, use_poly, G, D):
    """(bytes, flops) of the generation kernel k1_gen with kalpha's sum: reads
    the head factors, x*, X, alpha and the mask, writes k* and kalpha;
    flops of the k generation (as in :func:`k1_work`) and kalpha."""
    inputs = G * D + G + G * (D + 1) + 2 * G * D + P * D + M * D + 2 * G * M
    gen = 4 * D + 4 + (6 * D + 3 if use_poly else 0)
    return 4 * L * (inputs + G * P * M + G * P), L * G * P * M * (gen + 2)


def k2_work(L, P, M, use_poly, G, D):
    """(bytes, flops) of K2: reads K1's inputs, kF and the cotangents, writes
    dx*; flops of R = kF F^T and the chain rule per (particle, point)."""
    inputs = (G * D + G + G * (D + 1) + 2 * G * D + P * D + M * D + G * M + G * M * M + G * M
              + G * P * M + 2 * G * P)
    epi = 7 * D + 8 + (8 * D if use_poly else 0)
    return 4 * L * (inputs + P * D), L * G * P * M * (2 * M + epi)
