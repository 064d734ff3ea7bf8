"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,  # local MQA
    d_ff=7680,
    vocab=256000,
    hybrid_attn_every=3,  # (rec, rec, local-attn) groups
    lru_width=2560,
    local_window=2048,
    tie_embeddings=True,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
)


def smoke():
    return CONFIG.replace(
        n_layers=5, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512,
        lru_width=256, local_window=64,
    )
