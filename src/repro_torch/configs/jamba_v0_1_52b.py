"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
applied every other layer.  [arXiv:2403.19887; hf]

Period of 8: attention at index 4, Mamba elsewhere; MoE FFN on odd layers.
The published model's attention layers use no positional encoding; the
reference applies RoPE in every decoder attention layer, and the port keeps
the reference's semantics.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    attn_offset=4,
    ssm_d_state=16,
    ssm_expand=2,
    ssm_d_conv=4,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, n_experts=4, experts_per_token=2, moe_group_size=64,
        attn_chunk_q=64, attn_chunk_k=64, ssm_chunk=32, remat="none")
