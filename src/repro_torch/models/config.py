"""Unified model configuration: a copy of src/repro/models/config.py.

The fields are the same, so the configs copy over one to one, except the two
TPU switches ``attention_impl`` and ``kernel_interpret``: in this package the
device decides (a CPU tensor takes a kernel's plain version, a CUDA tensor
the kernel).  ``tdtype`` replaces ``jdtype``.  This slice runs the dense
family; the other families' fields are kept so their configs still load.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # attention variant: "full" or "sliding_window" (used for long-context
    # decode on otherwise-quadratic archs; see DESIGN.md)
    attention: str = "full"
    window: int = 8192

    # MoE — inference routing is dropless (exactness; see models/moe.py);
    # capacity_factor bounds the training dispatch buffers only
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # interleaved MoE (Llama-4 style): every ``moe_every``-th layer is MoE,
    # the rest are dense with ``moe_dense_ff`` FFN width (0 -> d_ff)
    moe_every: int = 1
    moe_dense_ff: int = 0

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (RG-LRU): pattern "rr a" repeated — attn_every = 3 means layers
    # [rec, rec, attn, rec, rec, attn, ...]; local attention window below.
    hybrid_attn_every: int = 3
    lru_width: int = 0  # 0 -> d_model
    local_window: int = 2048
    # Griffin uses block-diagonal recurrence/input gates; 16 blocks also makes
    # the gates communication-free under 16-way tensor parallelism (§Perf)
    lru_blocks: int = 16

    # encoder-decoder (Whisper backbone): encoder config mirrors decoder dims
    n_enc_layers: int = 0
    enc_len: int = 1500  # precomputed audio frame embeddings (stub frontend)

    # VLM early fusion: number of patch embeddings prepended (stub frontend)
    n_patches: int = 0

    # rematerialise layer activations during training (backward recompute);
    # essential for the large configs to fit HBM at train_4k
    remat: bool = True

    # scan over layers (compile-time O(1) in depth).  The roofline harness
    # unrolls (scan=False) small-L variants because XLA's cost analysis
    # counts while-loop bodies once, ignoring trip counts.
    scan: bool = True

    # source citation for assigned configs
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def tdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def lru_d(self) -> int:
        return self.lru_width if self.lru_width else self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp = 3 * d * f
        if self.arch_type == "moe":
            moe_mlp = self.n_experts * 3 * d * f + d * self.n_experts
            if self.moe_every > 1:
                n_moe = L // self.moe_every
                dense_ff = self.moe_dense_ff or f
                blocks = (
                    n_moe * (attn + moe_mlp + 2 * d)
                    + (L - n_moe) * (attn + 3 * d * dense_ff + 2 * d)
                )
                return emb + blocks
            mlp = moe_mlp
        if self.arch_type == "ssm":
            di, ns = self.d_inner, self.ssm_state
            blk = d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads) + di * d
            return emb + L * (blk + d)
        if self.arch_type == "hybrid":
            dl = self.lru_d
            # w_x, w_y, w_out dense + block-diagonal gates + conv
            rec = d * dl * 2 + dl * d + 2 * dl * dl // max(self.lru_blocks, 1) + 6 * dl
            n_attn = L // self.hybrid_attn_every
            n_rec = L - n_attn
            return emb + n_rec * (rec + mlp + 2 * d) + n_attn * (attn + mlp + 2 * d)
        blocks = L * (attn + mlp + 2 * d)
        if self.arch_type == "encdec":
            blocks += self.n_enc_layers * (attn + mlp + 2 * d) + L * attn  # cross-attn
        return emb + blocks

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.arch_type != "moe":
            return self.param_count()
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp = self.top_k * 3 * d * f + d * self.n_experts
        if self.moe_every > 1:
            n_moe = L // self.moe_every
            dense_ff = self.moe_dense_ff or f
            return emb + n_moe * (attn + mlp + 2 * d) + (L - n_moe) * (
                attn + 3 * d * dense_ff + 2 * d
            )
        return emb + L * (attn + mlp + 2 * d)
