"""The paper's own primary target/draft pair: Llama-3 70B / 8B Instruct
[arXiv:2407.21783].  TARGET is the assigned-pool-independent "paper config";
DRAFT is the 8B draft.  Used by the paper-faithful benchmarks at full scale
(dry-run only) and, in reduced form, by the runnable experiments."""
from repro_torch.models.config import ModelConfig

TARGET = ModelConfig(
    name="llama3-70b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783 (Llama 3 herd)",
)

DRAFT = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783 (Llama 3 herd)",
)

CONFIG = TARGET


def smoke():
    return TARGET.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512)


def smoke_draft():
    return DRAFT.replace(n_layers=1, d_model=128, n_heads=2, n_kv_heads=1, d_ff=256, vocab=512)
