"""arctic-480b [moe] — 128 experts top-2 with a parallel dense-FFN residual
path in every layer.  [hf:Snowflake/snowflake-arctic-base]

480 B parameters (about 960 GB in bf16) do not fit one card: the port runs
this config at its smoke size only."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    experts_per_token=2,
    moe_every=1,
    dense_residual=True,
    moe_group_size=1024,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab_size=512, n_experts=8, experts_per_token=2, moe_group_size=64,
        attn_chunk_q=64, attn_chunk_k=64, remat="none")
