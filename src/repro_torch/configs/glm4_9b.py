"""glm4-9b [dense] — RoPE, extreme GQA kv=2, large vocab.
[hf:THUDM/glm-4-9b; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    # dense attention arch: context-parallel + weight-gather beats TP when
    # head counts don't divide the 16-way model axis (EXPERIMENTS §Perf)
    parallelism="fsdp_cp",
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab_size=512, attn_chunk_q=64, attn_chunk_k=64, remat="none")
