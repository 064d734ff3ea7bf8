"""The plain reference against the port at a small size on the CPU, in
float32: the port's full forward pass agrees with it, target and draft."""
import json

import torch

from harness import check, spec
from harness.weights import draw_pair, model_configs, model_fields
from reference import llama

SMALL = {"target": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 96,
                    "vocab": 256, "dtype": "float32"},
         "draft": {"n_layers": 1, "d_model": 32, "n_heads": 2, "n_kv_heads": 1, "head_dim": 16, "d_ff": 48,
                   "vocab": 256, "dtype": "float32"}}
CONFIG = json.loads((spec.ROOT / "cardbench/configs/granite-8b.json").read_text())


def _fields(role):
    base = CONFIG if role == "target" else CONFIG["draft"]
    return {**model_fields(base), **SMALL[role]}


def test_reference_matches_the_port():
    from repro_torch.models.transformer import forward

    cfgs = model_configs(CONFIG, SMALL)
    params = draw_pair(CONFIG, *cfgs, 3, "cpu")
    tokens = torch.randint(0, 256, (40,), generator=torch.Generator().manual_seed(4))
    for cfg, p, role in zip(cfgs, params, ("target", "draft")):
        want, _, _ = forward(p, cfg, tokens[None], mode="full")
        got = llama.logits(p, _fields(role), tokens)
        assert got.shape == want[0].shape
        assert (got - want[0]).abs().max() < 1e-4 * want.abs().max()


def test_fp8_control_departs_and_the_gap_reads_it():
    cfgs = model_configs(CONFIG, SMALL)
    params, _ = draw_pair(CONFIG, *cfgs, 5, "cpu")
    cfg = _fields("target")
    tokens = torch.randint(0, 256, (64,), generator=torch.Generator().manual_seed(6))
    full = llama.logits(params, cfg, tokens)
    low = llama.logits(params, cfg, tokens, precision="fp8")
    assert 1e-3 < (low - full).abs().max() < 1.0
    served = full[31:].argmax(dim=-1).tolist()  # greedy tokens after a 32-token prompt
    assert float(check.gaps(full, 32, served).max()) == 0.0
    assert float(check.gaps(full, 32, served, low[31:].argmax(dim=-1)).max()) > 0.0
