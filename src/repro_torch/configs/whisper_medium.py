"""whisper-medium [audio] — enc-dec transformer backbone; the conv frontend
is a STUB (input_specs supplies precomputed frame embeddings).
[arXiv:2212.04356; unverified]

Shape-cell interpretation (DESIGN.md §5): encoder length = decoder length =
seq_len for train/prefill; decode cells run the decoder with a seq_len
self-KV cache and cross-attention to seq_len encoder states."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,             # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    frontend="frames",
    mlp_act="gelu",
    attn_bias=True,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, encoder_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512, attn_chunk_q=64, attn_chunk_k=64,
        remat="none")
