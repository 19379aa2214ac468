"""The BPTT clip of a rollout read at run time: the norms of the cotangents
that ``control.rollout._clip_bptt`` receives in the backward, and per
carried tensor the share of particles whose norm the cap cuts.

Measurement only: the rollout's own clip runs unchanged, and a hook on its
output sees the cotangent before the clip's backward scales it.
"""

from __future__ import annotations

import contextlib
import itertools

import torch

from ..control import rollout


@contextlib.contextmanager
def clip_cotangents(sink):
    """While open, each ``_clip_bptt`` output that takes part in autograd
    hands ``sink(call, norms)`` the per-particle norms (over the last axis)
    of the cotangent the clip receives.  ``call`` counts the calls of the
    forward from 0: a 4PMS step makes three, for the state, the raw
    measurement and the filtered velocity in that order.  A tensor that no
    gradient reaches (a rollout's first state, from the fixed particles)
    calls no sink."""
    orig, calls = rollout._clip_bptt, itertools.count()

    def clip(x, cap):
        y, i = orig(x, cap), next(calls)
        if y.requires_grad:
            def hook(g):
                sink(i, torch.sqrt(torch.sum(g * g, dim=-1)))
            y.register_hook(hook)
        return y

    rollout._clip_bptt = clip
    try:
        yield
    finally:
        rollout._clip_bptt = orig


class ClipShares:
    """A ``sink`` that keeps, per carried tensor (the call's index mod 3)
    and lane, the mean over backward calls of the share of particles whose
    cotangent norm exceeds ``cap``.  A call counts for a lane only where
    its cotangent is not zero and ``live()`` (if given: [lanes] bool) holds.
    The sums stay on ``device``, so a captured loop keeps them with no host
    read."""

    def __init__(self, cap: float, lanes: int = 1, device="cpu", live=None):
        self.cap, self.live = cap, live
        self.sums = torch.zeros((3, lanes), dtype=torch.float64, device=device)
        self.counts = torch.zeros_like(self.sums)

    def __call__(self, call: int, norms: torch.Tensor) -> None:
        n = torch.as_tensor(norms, device=self.sums.device).reshape(self.sums.shape[1], -1)
        w = (n > 0).any(dim=-1)
        if self.live is not None:
            w = w & self.live()
        w = w.double()
        self.sums[call % 3] += w * (n > self.cap).double().mean(dim=-1)
        self.counts[call % 3] += w

    def shares(self):
        """[lanes, 3] numpy: each lane's mean share per carried tensor."""
        return (self.sums / self.counts.clamp(min=1)).T.cpu().numpy()
