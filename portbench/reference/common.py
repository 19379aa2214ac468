"""The plain reference of one policy-optimizer call: the GP posterior (a
greedy subset-of-data selection where the configuration asks for one),
particle rollouts through it, the expected cost, its gradient by autograd,
global-norm clipping and Adam, in plain PyTorch at a dtype of the caller's
choice.  It imports nothing of the measured program: it takes the inputs
that the benchmark made from the seed (``inputs.py``) and draws the
rollouts' random numbers from the keys the program is handed, by the
documented scheme of those keys (a generator seeded from a BLAKE2b hash of
the key tuple, one stream per tag).

The configuration's own functions (features, plant model, kernel, cost,
policy input) live in a module of this package named by the
configuration's ``reference`` key.
"""

from __future__ import annotations

import hashlib
import math

import torch

STREAM_INIT, STREAM_ROLLOUT, STREAM_DROPOUT = 0x1A, 0x2B, 0x3C


def generator(key: tuple, device) -> torch.Generator:
    digest = hashlib.blake2b(repr(tuple(key)).encode(), digest_size=8).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest, "little") & ((1 << 63) - 1))
    return g


def draws(key: tuple, P: int, T: int, G: int, nb: int, ds: int, device):
    """The random numbers of the rollout keyed ``key``: next-state normals
    [T - 1, P, G], dropout uniforms [T, P, nb], initial-state normals [P, ds]
    (float32, as drawn)."""
    eps = torch.randn((T - 1, P, G), dtype=torch.float32, device=device,
                      generator=generator(key + (STREAM_ROLLOUT,), device))
    keep = torch.rand((T, P, nb), generator=generator(key + (STREAM_DROPOUT,), device),
                      device=device)
    init = torch.randn((P, ds), generator=generator(key + (STREAM_INIT,), device),
                       dtype=torch.float32, device=device)
    return eps, keep, init


def head(tree, g: int):
    """Head ``g``'s kernel parameters: the tree's leaves at index g."""
    if isinstance(tree, dict):
        return {k: head(v, g) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(head(v, g) for v in tree)
    return tree[g]


def to_tensors(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: to_tensors(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_tensors(v, dtype, device) for v in tree)
    return torch.as_tensor(tree, dtype=dtype, device=device)


def training_set(mod, measured, inputs, dtype, device):
    """(x [N, D], y [G, N]) of every trial: the features of each state and
    input but the last, and the next step's velocity change per head."""
    xs, ys = [], []
    for m, u in zip(measured, inputs):
        s = torch.as_tensor(m, dtype=dtype, device=device)
        a = torch.as_tensor(u, dtype=dtype, device=device)
        xs.append(mod.gp_inputs(s, a)[:-1])
        v = s[:, list(mod.VEL)]
        ys.append((v[1:] - v[:-1]).T)
    return torch.cat(xs), torch.cat(ys, dim=1)


def _jitter(diag, rel):
    return max(rel * float(diag.mean()), rel)


def sod_select(mod, kp, x, sn2: float, thr: float, rel: float):
    """The greedy subset of data of one head: candidates in index order,
    kept where the posterior std given the points kept so far, under noise
    sn2 plus the relative jitter of those points' prior variance, exceeds
    ``thr``.  Returns the kept indices."""
    K = mod.kernel(kp, x, x)
    prior = torch.diagonal(K)
    kept = [0]
    for i in range(1, x.shape[0]):
        S = torch.tensor(kept, device=x.device)
        A = K[S][:, S] + (sn2 + _jitter(prior[S], rel)) * torch.eye(len(kept), dtype=x.dtype,
                                                                   device=x.device)
        k = K[S, i]
        var = float(prior[i] - k @ torch.linalg.solve(A, k))
        if math.sqrt(max(var, 0.0)) > thr:
            kept.append(i)
    return kept


# the jitter scales a posterior is built at, the first whose factors exist
# kept: a float32 Cholesky of a nearly noiseless gram can fail
JITTER_SCALES = (1.0, 10.0, 100.0)


class Head:
    """One head's posterior: the points X [M, D], alpha [M], the factor F
    with F F^T = (K + (sn2 + jitter) I)^-1, the kernel parameters and the
    output scale; ``ok`` whether the Cholesky factor exists."""

    def __init__(self, mod, kp, X, y, sn2, rel, norm):
        K = mod.kernel(kp, X, X)
        self.A = K + (sn2 + _jitter(torch.diagonal(K), rel)) * torch.eye(
            X.shape[0], dtype=X.dtype, device=X.device)
        L, info = torch.linalg.cholesky_ex(self.A)
        self.ok = int(info) == 0
        eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        self.F = torch.linalg.solve_triangular(L, eye, upper=False).T
        self.alpha = torch.cholesky_solve((y / norm - mod.prior_mean(kp, X))[:, None], L)[:, 0]
        self.kp, self.X, self.norm, self.rel = kp, X, norm, rel


def posterior(mod, cfg: dict, lane: dict, dtype, device):
    """Every head's posterior from one lane's handed-in trials and
    hyperparameters, at the first of ``JITTER_SCALES`` at which every head's
    factor exists (the subsets selected anew at each).  Returns (heads,
    the scale)."""
    x, y = training_set(mod, lane["measured"], lane["inputs"], dtype, device)
    kernel = to_tensors(lane["kernel"], dtype, device)
    sn2 = torch.exp(2.0 * torch.as_tensor(lane["log_sigma_n"], dtype=dtype, device=device))
    for scale in JITTER_SCALES:
        rel, heads = cfg["gp_jitter"] * scale, []
        for g in range(cfg["num_heads"]):
            kp = head(kernel, g)
            norm = float(torch.max(torch.abs(y[g]))) if cfg["normalize_outputs"] else 1.0
            idx = list(range(x.shape[0]))
            if cfg.get("sod_threshold_relative") is not None:
                thr = cfg["sod_threshold_relative"] * math.sqrt(float(sn2[g]))
                idx = sod_select(mod, kp, x, float(sn2[g]), thr, rel)
            heads.append(Head(mod, kp, x[idx], y[g, idx], float(sn2[g]), rel, norm))
        if all(h.ok for h in heads):
            break
    return heads, scale


def predict(mod, heads, xs, delta_cap, mean_scale=1.0):
    """(mean, var) [G, P] at the inputs xs [P, D], in output units, the
    variance floored at the relative jitter of the prior, both capped at
    ``delta_cap`` times each head's output scale where one is set.
    ``mean_scale`` alters the mean (a planted fault)."""
    means, vars_ = [], []
    for h in heads:
        ks = mod.kernel(h.kp, xs, h.X)
        diag = mod.kdiag(h.kp, xs)
        mean = (mod.prior_mean(h.kp, xs) + ks @ h.alpha) * mean_scale
        quad = torch.sum((ks @ h.F) ** 2, dim=-1)
        var = torch.maximum(diag - quad, h.rel * diag)
        mean, var = mean * h.norm, var * h.norm**2
        if delta_cap is not None:
            lim = delta_cap * h.norm
            mean, var = torch.clamp(mean, -lim, lim), torch.clamp(var, max=lim * lim)
        means.append(mean)
        vars_.append(var)
    return torch.stack(means), torch.stack(vars_)


def policy(mod, cfg, params, s, keep, keep_prob):
    """The squashed RBF policy with inverted dropout: s [..., ds] -> u [..., 1]."""
    z = mod.policy_input(s)
    ls = torch.exp(params["log_lengthscales"])
    d = (z[..., None, :] - params["centers"]) / ls
    feats = torch.exp(-torch.sum(d * d, dim=-1)) * keep / keep_prob
    u = feats @ params["weight"].T
    return cfg["u_max"] * torch.tanh(u / cfg["u_max"])


def step(mod, cfg, heads, s, u, eps, mean_scale=1.0):
    """The model's next states of particles s [P, ds] under inputs u [P, 1]:
    the GP's velocity changes drawn with the normals eps [P, G], positions
    integrated by the trapezoid."""
    mean, var = predict(mod, heads, mod.gp_inputs(s, u), cfg.get("delta_cap"), mean_scale)
    delta = mean.T + torch.sqrt(var.T + 1e-12) * eps
    vel, pos, dt = list(mod.VEL), list(mod.POS), cfg["dt"]
    v = s[:, vel]
    nxt = s.clone()
    nxt[:, vel] = v + delta
    nxt[:, pos] = s[:, pos] + dt * v + 0.5 * dt * delta
    return nxt


def rollout(mod, cfg, heads, params, eps, keep, init, mean_scale=1.0):
    """One rollout from fresh particles: (states [T, P, ds], inputs [T, P, 1])."""
    dtype = params["weight"].dtype
    eps, init = eps.to(dtype), init.to(dtype)
    keep_prob = 1.0 - cfg["p_dropout"]
    kept = (keep < keep_prob).to(dtype)
    mean0 = torch.as_tensor(cfg["init_mean"], dtype=dtype, device=eps.device)
    s = mean0 + math.sqrt(cfg["init_var"]) * init
    states, inputs = [s], [policy(mod, cfg, params, s, kept[0], keep_prob)]
    for t in range(1, cfg["horizon"]):
        s = step(mod, cfg, heads, s, inputs[-1], eps[t - 1], mean_scale)
        states.append(s)
        inputs.append(policy(mod, cfg, params, s, kept[t], keep_prob))
    return torch.stack(states), torch.stack(inputs)


def expected_cost(mod, states, particles=None):
    """(the sum over time of the particles' mean stage cost, and of their
    std, ddof 1, detached); ``particles``: over the first that many only."""
    c = mod.stage_cost(states)  # [T, P]
    if particles is not None:
        c = c[:, :particles]
    return torch.sum(c.mean(dim=1)), torch.sum(c.detach().std(dim=1))


LEAVES = ("log_lengthscales", "centers", "weight")


def clipped(g: dict, max_norm: float) -> dict:
    """The gradient clipped to a global norm of ``max_norm``, as the
    optimizer gets it."""
    gn = math.sqrt(sum(float(torch.sum(t * t)) for t in g.values()))
    scale = min(max_norm / (gn + 1e-12), 1.0)
    return {k: t * scale for k, t in g.items()}


@torch.no_grad()
def first_cost(mod, cfg, heads, params0: dict, key: tuple, dtype, device) -> float:
    """The cost of the rollout keyed ``key + (0, 0)`` from ``params0``: a
    call's first cost."""
    P, T, G = cfg["num_particles"], cfg["horizon"], cfg["num_heads"]
    eps, keep, init = draws(tuple(key) + (0, 0), P, T, G, cfg["policy"]["num_basis"],
                            len(cfg["init_mean"]), device)
    p = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in params0.items()}
    states, _ = rollout(mod, cfg, heads, p, eps, keep, init)
    return float(expected_cost(mod, states)[0])


# the faults ``run_steps`` plants: the cost's mean over half of the
# particles; the cost as it is, its gradient over half of the particles;
# the cost, or the GP's predicted mean, a tenth too large; the gradient
# negated
FAULTS = ("half_batch", "half_gradient", "cost_altered", "prediction_altered", "grad_negated")


def run_steps(mod, cfg, heads, params0: dict, key: tuple, steps: int, dtype, device,
              fault=None) -> dict:
    """``steps`` optimizer steps from ``params0`` on the keys ``key + (s, 0)``:
    each step's cost, the params that scored it, and per step (``trace``)
    its gradient as the optimizer gets it (clipped), the params it was
    taken at and its rollout's states; the last rollout (states, inputs).
    ``fault``: one of ``FAULTS``, planted."""
    p = {k: torch.as_tensor(v, dtype=dtype, device=device).clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps_adam, lr = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["learning_rate"]
    P, T, G = cfg["num_particles"], cfg["horizon"], cfg["num_heads"]
    nb, ds = cfg["policy"]["num_basis"], len(cfg["init_mean"])
    mean_scale = 1.1 if fault == "prediction_altered" else 1.0
    out = dict(costs=[], scored=[], trace=[])
    for s in range(steps):
        eps, keep, init = draws(tuple(key) + (s, 0), P, T, G, nb, ds, device)
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        states, inputs = rollout(mod, cfg, heads, leaves, eps, keep, init, mean_scale)
        c, _ = expected_cost(mod, states, P // 2 if fault == "half_batch" else None)
        if fault == "half_gradient":
            half, _ = expected_cost(mod, states, P // 2)
            c = c.detach() + half - half.detach()
        if fault == "cost_altered":
            c = c * 1.1
        g = dict(zip(LEAVES, torch.autograd.grad(c, [leaves[k] for k in LEAVES])))
        if fault == "grad_negated":
            g = {k: -t for k, t in g.items()}
        g = clipped(g, cfg["grad_clip_norm"])
        out["costs"].append(float(c.detach()))
        out["scored"].append({k: t.detach().clone() for k, t in p.items()})
        out["trace"].append(dict(grad=g, params=out["scored"][-1], states=states.detach()))
        out["states"], out["inputs"] = states.detach(), inputs.detach()
        n = s + 1
        with torch.no_grad():
            for k in LEAVES:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
                p[k] = p[k] - lr * (m[k] / (1 - b1**n)) / (torch.sqrt(v2[k] / (1 - b2**n))
                                                          + eps_adam)
    return out


def forced_grad(mod, cfg, heads, params: dict, states, key: tuple, dtype) -> dict:
    """The gradient of the cost of the rollout ``states`` [T, P, ds] (keyed
    ``key``, taken at ``params``) along those very states, clipped as the
    optimizer clips it: each step's next state is the model's, with the
    gap to the given state added as a constant, so the forward values are
    the given rollout's and the backward takes the model's derivatives at
    its states.  A rollout that parted from the reference's own (float32
    does that to a few particles) is thus judged on its own path."""
    T, P, ds = states.shape
    eps, keep, _ = draws(tuple(key), P, T, cfg["num_heads"], cfg["policy"]["num_basis"], ds,
                         states.device)
    S = states.to(dtype)
    eps = eps.to(dtype)
    keep_prob = 1.0 - cfg["p_dropout"]
    kept = (keep < keep_prob).to(dtype)
    leaves = {k: torch.as_tensor(params[k], dtype=dtype, device=states.device)
              .detach().clone().requires_grad_(True) for k in LEAVES}
    s = S[0]
    path, u = [s], policy(mod, cfg, leaves, s, kept[0], keep_prob)
    for t in range(1, T):
        nxt = step(mod, cfg, heads, s, u, eps[t - 1])
        s = nxt + (S[t] - nxt).detach()
        path.append(s)
        u = policy(mod, cfg, leaves, s, kept[t], keep_prob)
    c, _ = expected_cost(mod, torch.stack(path))
    g = dict(zip(LEAVES, torch.autograd.grad(c, [leaves[k] for k in LEAVES])))
    return clipped(g, cfg["grad_clip_norm"])


@torch.no_grad()
def one_step(mod, cfg, heads, states, inputs, key: tuple, dtype):
    """The model's next state from each state and input of a rollout
    (states [T, P, ds], inputs [T, P, 1], keyed ``key``), each taken as
    given: [T - 1, P, ds]."""
    T, P, ds = states.shape
    eps, _, _ = draws(tuple(key), P, T, cfg["num_heads"], cfg["policy"]["num_basis"], ds,
                      states.device)
    s = states[:-1].to(dtype).reshape(-1, ds)
    u = inputs[:-1].to(dtype).reshape(-1, inputs.shape[-1])
    return step(mod, cfg, heads, s, u, eps.to(dtype).reshape(-1, eps.shape[-1])).reshape(
        T - 1, P, ds)


@torch.no_grad()
def policy_at(mod, cfg, params, states, key: tuple, dtype):
    """The policy's inputs at each state of a rollout keyed ``key`` (its
    dropout draw): [T, P, 1]."""
    T, P, ds = states.shape
    _, keep, _ = draws(tuple(key), P, T, cfg["num_heads"], cfg["policy"]["num_basis"], ds,
                       states.device)
    keep_prob = 1.0 - cfg["p_dropout"]
    p = {k: torch.as_tensor(v, dtype=dtype, device=states.device) for k, v in params.items()}
    return policy(mod, cfg, p, states.to(dtype), (keep < keep_prob).to(dtype), keep_prob)
