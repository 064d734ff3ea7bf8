"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512)
