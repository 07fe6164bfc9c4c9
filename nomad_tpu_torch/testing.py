"""Helpers shared by the port's tests and chip_smoke.py."""
from __future__ import annotations

import contextlib
import os

import numpy as np


@contextlib.contextmanager
def seeded_urandom(seed):
    """os.urandom from a seeded stream for the block's length: two runs of
    one eval, each in such a block with the same seed, mint the same
    allocation ids."""
    rng = np.random.default_rng(seed)
    real = os.urandom
    os.urandom = lambda n: rng.bytes(n)
    try:
        yield
    finally:
        os.urandom = real


def fill_count(view, cpu, mem) -> int:
    """Instances of (cpu MHz, mem MB) that fit on a usage view's free
    capacity, node by node."""
    free = view.cap[:, :2] - view.used[:, :2]
    return int(np.floor(np.min(free / np.array([cpu, mem], np.float32),
                               axis=1)).clip(min=0).sum())
