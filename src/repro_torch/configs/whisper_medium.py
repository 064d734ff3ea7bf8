"""whisper-medium [audio] — enc-dec transformer backbone; conv/mel frontend
is a stub (the caller provides precomputed frame embeddings)
[arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    enc_len=1500,
    source="arXiv:2212.04356 (Robust Speech Recognition via Large-Scale Weak Supervision)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, n_enc_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab=512, enc_len=24,
    )
