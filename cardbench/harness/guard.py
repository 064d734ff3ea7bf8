"""The import guard: the benchmark measures the PyTorch port alone.

Names are compared by their top-level part (before the first dot), whole:
``repro_torch`` is the port and passes, ``repro`` is the JAX package and
does not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every module
    this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


class ForbiddenImport(RuntimeError):
    pass


def check(when: str) -> None:
    """Raise ``ForbiddenImport`` naming what was found, if anything."""
    found = forbidden_loaded()
    if found:
        raise ForbiddenImport(f"{when}: the process has loaded {', '.join(found)}; the benchmark "
                              "measures the PyTorch port only")
