"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    source="arXiv:2405.04324 (Granite Code Models)",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512)
