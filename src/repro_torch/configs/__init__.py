"""Architecture config registry: ``get_config(name)`` / ``get_smoke(name)``.

The counterpart of src/repro/configs/__init__.py, with the same configs:
the dense ones (granite-8b, granite-3-2b, minitron-8b, qwen2-72b with its
QKV bias, and the paper's Llama-3 70B/8B pair), the two MoE configs
(qwen3-moe flat, llama4-maverick interleaved), the SSM mamba2-2.7b, the
hybrid recurrentgemma-2b, the encoder-decoder whisper-medium and the VLM
internvl2-26b.
"""
from __future__ import annotations

import importlib

ARCHES = {
    "granite-8b": "granite_8b",
    "granite-3-2b": "granite_3_2b",
    "minitron-8b": "minitron_8b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen2-72b": "qwen2_72b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-medium": "whisper_medium",
    "internvl2-26b": "internvl2_26b",
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
