"""What a run may not have loaded: JAX, Flax and the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word, so ``hpslam_tpu_torch`` (the program) passes
and ``hpslam_tpu`` (the JAX package it was ported from) does not; ``bench``
is the JAX package's top-level benchmark script.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hpslam_tpu", "bench"})


def offending(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
