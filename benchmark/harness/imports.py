"""The check that the run loaded neither JAX nor the JAX package.

Names are compared whole, by their top-level part (before the first dot):
the port, stark_verifier_tpu_torch, begins with the JAX package's name
and is not it.
"""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "stark_verifier_tpu")


def top_levels(names) -> set:
    return {n.split(".")[0] for n in names}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (default sys.modules)."""
    names = top_levels(sys.modules if modules is None else modules)
    return sorted(names & set(FORBIDDEN))
