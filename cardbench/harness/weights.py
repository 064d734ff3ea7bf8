"""Model configurations from a configuration file, and weights drawn from the
seed on the device.

What belongs to one model family (how its weights are drawn, its active
parameter count, its plain reference) lives in ``reference/<family>.py``,
which the configuration file names under ``reference``.  The same tensors go
to the program and to the reference.
"""
from __future__ import annotations

import importlib

import torch

# keys of a configuration file that are no ModelConfig field
META_KEYS = ("name", "source", "reference", "deployment", "reduced", "published", "assumed", "draft", "params",
             "weights")


def model_fields(spec: dict) -> dict:
    return {k: v for k, v in spec.items() if k not in META_KEYS}


def family(config: dict):
    """The module ``reference/<family>.py`` the configuration file names."""
    return importlib.import_module(f"reference.{config['reference']}")


def model_configs(config: dict, overrides: dict | None = None):
    """(target, draft) ``ModelConfig`` of a configuration file; ``overrides``
    ({"target": {...}, "draft": {...}}) replace fields (the CPU tests' small
    sizes)."""
    from repro_torch.models.config import ModelConfig

    overrides = overrides or {}
    tgt = ModelConfig(name=config["name"], **{**model_fields(config), **overrides.get("target", {})})
    drf = ModelConfig(name=config["name"] + "-draft", **{**model_fields(config["draft"]), **overrides.get("draft", {})})
    return tgt, drf


def draw_pair(config: dict, tcfg, dcfg, seed: int, device) -> tuple[dict, dict]:
    """(target, draft) weights of the configuration's family from ``seed``,
    by one generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return family(config).draw_pair(tcfg, dcfg, gen, config["weights"])
