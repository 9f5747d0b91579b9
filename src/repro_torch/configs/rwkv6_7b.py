"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,             # rwkv heads = d_model / head_size
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_size=64,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab_size=512, rwkv_head_size=64, rwkv_chunk=16, remat="none")
