"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2 language
decoder backbone [arXiv:2404.16821].

The caller provides precomputed patch embeddings (the ViT and projector are
a stub); this config is the 48-layer language decoder with early fusion.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    n_patches=256,  # one 448x448 tile -> 256 visual tokens after projector
    source="arXiv:2404.16821 (InternVL 1.5/2 family; InternLM2-20B decoder)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, d_ff=512, vocab=512, n_patches=8
    )
