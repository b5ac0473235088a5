"""The run's process may not hold JAX or the JAX package: checked by the
top-level name of each loaded module, compared whole (the port's package
name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "yoloseries_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
