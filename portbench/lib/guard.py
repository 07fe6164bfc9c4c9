"""The check that a run loaded neither JAX nor the JAX package.

Names are compared whole, by the part before the first dot: the port,
nomad_tpu_torch, begins with the JAX package's name and must pass.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
