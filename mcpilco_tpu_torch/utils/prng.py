"""Named random streams as ``torch.Generator``s.

A key is a tuple of integers: the seed, then the stream tags and counters
folded into it, in the order ``mcpilco_tpu.utils.prng`` folds them.  A key is
turned into a generator only where numbers are drawn, seeded from a stable
hash of the whole tuple, so every stream is a pure function of
(seed, stream tag, counters) regardless of call order.  The port does not
reproduce threefry: tests that compare with JAX hand both sides the same
draws.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

Key = Tuple[int, ...]

STREAM_INIT_PARTICLES = 0x1A
STREAM_ROLLOUT = 0x2B
STREAM_DROPOUT = 0x3C
STREAM_POLICY_INIT = 0x4D
STREAM_EXPLORATION = 0x5E
STREAM_MEAS_NOISE = 0x6F
STREAM_MODEL_FIT = 0x70
STREAM_SYSTEM = 0x81
STREAM_RESTARTS = 0x92


def root_key(seed: int) -> Key:
    return (int(seed),)


def stream(key: Key, tag: int) -> Key:
    """Derive the key of one named random stream."""
    return key + (int(tag),)


def fold(key: Key, *indices) -> Key:
    """Fold a sequence of integer counters into ``key``."""
    return key + tuple(int(i) for i in indices)


def split(key: Key, num: int) -> list:
    """``num`` independent keys derived from ``key`` (``jax.random.split``'s
    role)."""
    return [fold(key, i) for i in range(num)]


def generator(key: Key, device) -> torch.Generator:
    """A generator on ``device`` seeded from the whole key."""
    digest = hashlib.blake2b(repr(tuple(key)).encode(), digest_size=8).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest, "little") & ((1 << 63) - 1))
    return g
