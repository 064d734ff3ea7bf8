"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,  # per-expert FFN width
    vocab=202048,
    n_experts=128,
    top_k=1,
    head_dim=128,
    moe_every=2,  # Maverick interleaves dense and MoE layers (1:1)
    moe_dense_ff=16384,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (Llama 4 MoE family)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=256, vocab=512,
        n_experts=4, top_k=1, head_dim=64, moe_dense_ff=512,
    )
