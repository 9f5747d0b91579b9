"""llama3.2-3b [dense] — small llama3, GQA kv=8, 500k rope theta.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    # dense attention arch: context-parallel + weight-gather beats TP when
    # head counts don't divide the 16-way model axis (EXPERIMENTS §Perf)
    parallelism="fsdp_cp",
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab_size=512, attn_chunk_q=64, attn_chunk_k=64, remat="none")
