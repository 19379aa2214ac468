"""The delta cap of a rollout read at run time: per rollout step, head and
particle, whether ``RolloutEngine.delta_cap`` changed the predicted mean or
variance.

Measurement only: the rollout's own cap runs unchanged.  While the probe is
open, ``MultiGP.predict`` keeps its last output and a wrapper around
``RolloutEngine._predict`` compares it with what the cap returned, so the
probe holds no copy of the cap's arithmetic.
"""

from __future__ import annotations

import contextlib

import torch

from ..control.rollout import RolloutEngine
from ..models.gp import MultiGP


def _changed(after: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """Where the cap changed a value (a NaN prediction counts as unchanged)."""
    return (after != before) & ~torch.isnan(before)


@contextlib.contextmanager
def delta_cap_binding(sink):
    """While open, each ``RolloutEngine._predict`` of an engine with a
    ``delta_cap`` hands ``sink(bound, mean, var)`` the [*L, G, P] bool tensor
    of the particles whose predicted mean or variance the cap changed, and
    the prediction before the cap, one call per rollout step in order."""
    predict, capped = MultiGP.predict, RolloutEngine._predict
    raw = []

    def keep(self, *args, **kwargs):
        out = predict(self, *args, **kwargs)
        raw.append(out)
        return out

    def probe(self, gp_params, posterior, gp_in):
        raw.clear()
        mean, var = capped(self, gp_params, posterior, gp_in)
        if self.delta_cap is not None:
            mean0, var0 = raw[-1]
            with torch.no_grad():
                sink(_changed(mean, mean0) | _changed(var, var0), mean0.detach(),
                     var0.detach())
        return mean, var

    MultiGP.predict, RolloutEngine._predict = keep, probe
    try:
        yield
    finally:
        MultiGP.predict, RolloutEngine._predict = predict, capped


class CapShares:
    """A ``sink`` that stacks the binding masks of the calls it receives:
    ``array()`` gives [steps, *L, G, P] bool, ``share()`` the share of
    particle-steps (any head) at which the cap bound."""

    def __init__(self):
        self.masks = []

    def __call__(self, bound: torch.Tensor, *raw) -> None:
        self.masks.append(bound.cpu())

    def array(self):
        return torch.stack(self.masks).numpy()

    def share(self) -> float:
        if not self.masks:
            return float("nan")
        return float(self.array().any(axis=-2).mean())
