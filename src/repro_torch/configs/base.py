"""Config system: model / shape / parallelism / PIM-TRQ settings.

A copy of ``repro.configs.base`` (the JAX package's config dataclasses) so
the PyTorch port imports nothing of the JAX package.  Every architecture is
a ``ModelConfig`` instance in its own module (``configs/<id>.py``),
selectable by ``--arch <id>``.  ``smoke()`` returns the reduced same-family
config the CPU parity tests use; the full config runs on the GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TRQConfig:
    """Per-model default SAR register settings (overridable per layer by the
    Algorithm-1 calibration output)."""
    n_r1: int = 6
    n_r2: int = 6
    m: int = 4
    bias: float = 0.0
    delta_r1: float = 1.0
    signed: bool = True          # LM fast path quantizes signed partial sums
    # ADC integer grid scale for the fake-quant path: partial sums are
    # expressed in units of delta_grid before quantization.
    delta_grid: float = 1.0
    # uncalibrated default: auto-fit the coarse range to the observed
    # per-layer |psum| max (Algorithm-1 calibration overrides with exact
    # registers and turns this off)
    auto_range: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1           # apply MoE FFN every k-th layer (jamba: 2)
    moe_d_ff: Optional[int] = None
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    moe_group_size: int = 2048   # GShard dispatch group (tokens)

    # --- hybrid / ssm ---
    attn_every: int = 1          # jamba: 8 (attention at one layer per 8)
    attn_offset: int = 0         # index of the attention layer in the period
    ssm_d_state: int = 16
    ssm_expand: int = 2
    ssm_d_conv: int = 4
    rwkv_head_size: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0

    # --- modality frontends (stubs per task spec) ---
    frontend: str = "none"       # none | patch (vlm) | frames (audio)
    frontend_len: int = 0        # patches/frames occupying the sequence head

    # --- common transformer knobs ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_act: str = "silu"        # silu (gated) | gelu (whisper-style)
    attn_bias: bool = False
    sliding_window: int = 0      # 0 = full causal

    # --- PIM / TRQ integration ---
    # name in the repro_torch.pim.backend registry: exact | fake_quant | pallas |
    # bit_exact | noisy (serving default set by the launcher; training
    # stays exact = paper; noisy needs a CrossbarModel to differ from
    # bit_exact).  Overridable at runtime by a use_backend(...) context.
    pim_backend: str = "exact"
    trq: TRQConfig = TRQConfig()

    # --- impl knobs (perf-tunable; see EXPERIMENTS §Perf) ---
    # 'tp'      — Megatron-style: heads/ffn over 'model' (baseline)
    # 'fsdp_cp' — context-parallel: activations stay seq-sharded through
    #             the whole layer, weights all-gathered per layer (ZeRO-3
    #             style).  Wins when heads don't divide the model axis
    #             (EXPERIMENTS.md §Perf iter 2); dense archs only.
    parallelism: str = "tp"
    attn_chunk_q: int = 256
    # effective kv chunk is min(seq, attn_chunk_k).  MEASURED (§Perf iter
    # 3, refuted): fewer/bigger kv chunks trade scan-carry HBM traffic for
    # materialized score tiles and lose at 4k (3279ms vs 2414ms memory
    # term) — 1024 stays the default; the real fix is the fused flash
    # kernel keeping carries VMEM-resident.
    attn_chunk_k: int = 1024
    ssm_chunk: int = 256
    rwkv_chunk: int = 32
    scan_layers: bool = True
    remat: str = "block"         # none | block | full
    dtype: str = "bfloat16"      # compute dtype
    param_dtype: str = "float32" # master weights (serve paths use bfloat16)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (scan unit)."""
        import math
        p = 1
        if self.attn_every > 1:
            p = self.attn_every
        if self.n_experts and self.moe_every > 1:
            p = p * self.moe_every // math.gcd(p, self.moe_every)
        return p

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, \
            f"{self.name}: n_layers={self.n_layers} not divisible by period={self.period}"
        return self.n_layers // self.period

    def layer_kind(self, idx: int) -> tuple[str, str]:
        """(mixer, ffn) for layer ``idx``: mixer in {attn, mamba, rwkv},
        ffn in {mlp, moe, moe+mlp, none}."""
        if self.family == "ssm":
            mixer = "rwkv"
        elif self.family == "hybrid":
            mixer = "attn" if (idx % self.attn_every) == self.attn_offset else "mamba"
        else:
            mixer = "attn"
        if self.family == "ssm":
            ffn = "mlp"
        elif self.n_experts and (idx % self.moe_every) == (self.moe_every - 1):
            ffn = "moe+mlp" if self.dense_residual else "moe"
        elif self.n_experts and self.dense_residual:
            ffn = "moe+mlp"   # arctic applies MoE+dense in every layer
        else:
            ffn = "mlp"
        return mixer, ffn

    def replace(self, **kw) -> "ModelConfig":
        if "pim_mode" in kw:
            # the pre-backend-registry name, removed after one deprecation
            # cycle: a clear error beats dataclasses.replace's
            # generic "unexpected keyword"
            raise TypeError(
                "ModelConfig.pim_mode was removed; use "
                "pim_backend=<backend registry name>, e.g. "
                "cfg.replace(pim_backend='fake_quant')")
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic token mixing); pure
# full-attention archs skip it per the task spec (see DESIGN.md §5)
LONG_CONTEXT_ARCHS = ("rwkv6-7b", "jamba-v0.1-52b")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    microbatch: int = 0          # 0 = no gradient accumulation
    # distributed-optimization tricks
    optimizer_dtype: str = "float32"   # float32 | bfloat16 second moments
    factored_second_moment: bool = False  # Adafactor-style v (rows+cols)
    zero1: bool = True           # shard optimizer state over the data axis
    checkpoint_every: int = 100
    watchdog_factor: float = 3.0  # straggler flag: step > factor * median
