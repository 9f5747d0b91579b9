"""granite-moe-3b-a800m [moe] — 40 experts top-8, narrow d_ff=512 experts.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]

These are the 3b-a800m model's dimensions (32 layers, d=1,536, 24 query and
8 KV heads of 64, 40 experts of d_ff 512, top-8, vocab 49,155, tied
embeddings).  The published model scales its embeddings, residuals,
attention and logits by constant multipliers and routes without a
capacity bound; the reference's generic MoE decoder has neither, and the
port keeps the reference's semantics."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    experts_per_token=8,
    moe_every=1,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=64,
        vocab_size=512, n_experts=8, experts_per_token=2, moe_group_size=64,
        attn_chunk_q=64, attn_chunk_k=64, remat="none")
