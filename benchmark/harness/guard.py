"""The run may not hold JAX or the JAX package: modules are compared by
their whole top-level name (the port's own name begins with the JAX
package's)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "slr_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
