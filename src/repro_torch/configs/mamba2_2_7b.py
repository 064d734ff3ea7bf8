"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    ssm_groups=1,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Transformers are SSMs: Mamba-2)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, vocab=512, ssm_state=32, ssm_headdim=32, ssm_chunk=16
    )
