"""deepseek-7b [dense] — llama-arch, MHA (kv=32).  [arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    # dense attention arch: context-parallel + weight-gather beats TP when
    # head counts don't divide the 16-way model axis (EXPERIMENTS §Perf)
    parallelism="fsdp_cp",
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, attn_chunk_q=64, attn_chunk_k=64, remat="none")
