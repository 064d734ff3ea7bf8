"""qwen2-72b [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    source="arXiv:2407.10671 (Qwen2 Technical Report)",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512)
