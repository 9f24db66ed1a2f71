"""The fence: nothing the benchmark runs may load JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot) as a whole word, since the port's name, `gim_tpu_torch`, begins
with the JAX package's.
"""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gim_tpu"})


def forbidden(modules) -> list[str]:
    """The names in `modules` whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
