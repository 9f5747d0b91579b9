"""deepseek-67b [dense] — llama-arch, GQA kv=8.  [arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    # dense attention arch: context-parallel + weight-gather beats TP when
    # head counts don't divide the 16-way model axis (EXPERIMENTS §Perf)
    parallelism="fsdp_cp",
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab_size=512, attn_chunk_q=64, attn_chunk_k=64, remat="none")
