"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B
family scaling]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,  # per-expert FFN width
    vocab=151936,
    n_experts=128,
    top_k=8,
    head_dim=128,
    source="hf:Qwen/Qwen3-30B-A3B (Qwen3 MoE family)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
        n_experts=4, top_k=2, head_dim=64,
    )
