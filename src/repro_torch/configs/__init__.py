"""Architecture config registry: ``get_config(name)`` / ``get_smoke(name)``.

The counterpart of src/repro/configs/__init__.py for the families this
package runs so far: the dense granite pair and the paper's Llama-3 70B/8B
pair.  The other families join with the slices that port their layers.
"""
from __future__ import annotations

import importlib

ARCHES = {
    "granite-8b": "granite_8b",
    "granite-3-2b": "granite_3_2b",
    "paper-llama70b": "paper_llama70b_8b",
}


def _mod(name: str):
    if name not in ARCHES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHES[name]}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).smoke()


def list_arches() -> list[str]:
    return [a for a in ARCHES if a != "paper-llama70b"]
