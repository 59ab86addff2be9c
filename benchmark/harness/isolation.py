"""The benchmark measures the port alone: no JAX, no JAX package.

Names are compared whole, by the part before the first dot:
``kubeoperator_tpu_torch`` is the port and allowed, though its name
begins with the JAX package's.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kubeoperator_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))


def assert_isolated(where: str) -> None:
    """Raise if a forbidden module is loaded in this process."""
    bad = forbidden_loaded()
    if bad:
        raise RuntimeError(f"{where}: loaded {bad}; the benchmark measures "
                           f"the PyTorch port alone")
