"""internvl2-76b [vlm] — InternViT + InternLM2 backbone; the vision frontend
is a STUB (input_specs supplies precomputed patch embeddings for the first
``frontend_len`` sequence positions).  [arXiv:2404.16821; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    # dense attention arch: context-parallel + weight-gather beats TP when
    # head counts don't divide the 16-way model axis (EXPERIMENTS §Perf)
    parallelism="fsdp_cp",
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="patch",
    frontend_len=256,        # patch tokens per image, precomputed
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab_size=512, frontend_len=16, attn_chunk_q=64, attn_chunk_k=64,
        remat="none")
