"""minitron-8b [dense] — pruned Nemotron [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    source="arXiv:2407.14679 (Minitron: Compact Language Models via Pruning and Distillation)",
)


def smoke():
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512)
