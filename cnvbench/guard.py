"""The run's own check that nothing of JAX or of the JAX package was loaded.

Modules are compared by their top-level name (before the first dot), whole:
``infercnvpy_tpu_torch`` is the port and passes, ``infercnvpy_tpu`` fails.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "infercnvpy_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Names among ``names`` (default: ``sys.modules``) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
