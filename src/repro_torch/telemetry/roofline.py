"""Roofline terms of one step and the model's useful FLOPs (port of
``repro.telemetry.roofline``), against one NVIDIA H100.

Per (arch x shape x mesh) the dry run (``launch.dryrun``) supplies global
quantities, each rank's count times the ranks:

* ``hlo_flops``  — FLOPs of the step, from ``torch.utils.flop_counter``
  over the aten operations one rank runs (the name is the reference's);
* ``hlo_bytes``  — the bytes one rank's step must move through HBM: its
  arguments' and outputs' local shards and the peak of its intermediates;
* ``collective_bytes`` — the bytes of the collectives one rank issues.

Terms (seconds for one step, the whole mesh advancing together)::

    compute    = hlo_flops        / (chips x peak FLOP/s)
    memory     = hlo_bytes        / (chips x HBM bytes/s)
    collective = collective_bytes / (chips x link bytes/s)

``H100`` holds the card's data-sheet rates; it is the one ``HwSpec`` here
and the default.  Unlike the reference, whose ``roofline_frac`` divides by
its TPU's peak whatever ``hw`` the report was made with, the port divides
by the report's own ``hw`` (the two agree when ``hw`` is that TPU).

The card constants that ``chip_smoke.py`` bounds its kernels with live
here too, so the bounds and the roofline have one source.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float        # FLOP/s per chip (bf16 dense)
    hbm_bw: float            # bytes/s per chip
    link_bw: float           # bytes/s per chip to its peers
    hbm_bytes: float         # HBM capacity per chip


# NVIDIA H100 SXM data sheet: dense bf16, HBM3 at 3.35 TB/s, 80 GB, NVLink 4
# at 900 GB/s (a mesh across nodes sees its network's rate instead)
H100 = HwSpec(name="h100-sxm",
              peak_flops=989e12,
              hbm_bw=3.35e12,
              link_bw=900e9,
              hbm_bytes=80e9)

HBM_BYTES_PER_S = H100.hbm_bw      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores
# one-bit AND-popcount tensor cores (K3's type): the data sheet gives no
# rate, so the highest that tools/k3_mma_rates.cu measured (mma.m16n8k256,
# an H100 80GB HBM3 at 700 W)
B1_OPS_PER_S = 9064.3e12


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float       # global
    model_flops: float            # 6·N·D (dense) / 6·N_active·D (MoE)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    bytes_per_device: float = 0.0
    hw: HwSpec = H100

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_frac(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the redundancy detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline reached if the step ran at the
        dominant term: MODEL_FLOPS / (chips x peak of ``hw``) / step_s."""
        if self.step_s <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * self.hw.peak_flops)
        return ideal / self.step_s

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hw": self.hw.name,
            "hlo_tflops": self.hlo_flops / 1e12,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.collective_bytes / 1e9,
            "model_tflops": self.model_flops / 1e12,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "bottleneck": self.bottleneck,
            "useful_flop_frac": self.useful_flop_frac,
            "roofline_frac": self.roofline_frac,
            "bytes_per_dev_gb": self.bytes_per_device / 1e9,
        }


def roofline(arch: str, shape: str, mesh: str, chips: int,
             hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             model_flops: float, bytes_per_device: float = 0.0,
             hw: HwSpec = H100) -> RooflineReport:
    r = RooflineReport(arch=arch, shape=shape, mesh=mesh, chips=chips,
                       hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
                       collective_bytes=collective_bytes,
                       model_flops=model_flops,
                       bytes_per_device=bytes_per_device, hw=hw)
    r.compute_s = hlo_flops / (chips * hw.peak_flops)
    r.memory_s = hlo_bytes / (chips * hw.hbm_bw)
    r.collective_s = collective_bytes / (chips * hw.link_bw)
    terms = {"compute": r.compute_s, "memory": r.memory_s,
             "collective": r.collective_s}
    r.bottleneck = max(terms, key=terms.get)
    return r


# ---------------------------------------------------------------------------
# MODEL_FLOPS — 6·N·D (train), 2·N·D (inference) with MoE active-param N
# ---------------------------------------------------------------------------

def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count from a ModelConfig (the reference's
    formula, which the dense decoders' counts match)."""
    d, v = cfg.d_model, cfg.vocab_size
    hd = cfg.hd
    emb = v * d
    head = 0 if cfg.tie_embeddings else d * v
    total = emb + head

    def attn_params():
        return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
            + cfg.n_heads * hd * d

    def mlp_params(dff):
        mult = 3 if cfg.mlp_act == "silu" else 2
        return mult * d * dff

    def moe_params(active):
        e = cfg.experts_per_token if active else cfg.n_experts
        dff = cfg.moe_d_ff or cfg.d_ff
        return e * 3 * d * dff + d * cfg.n_experts

    def mamba_params():
        di = d * cfg.ssm_expand
        return d * 2 * di + di * d + di * cfg.ssm_d_conv \
            + di * (cfg.ssm_d_state * 2 + 2) + 2 * di

    def rwkv_params():
        return 4 * d * d + d * d + 2 * d + 64 * d * 2

    for i in range(cfg.period):
        mixer, ffn = cfg.layer_kind(i)
        layer = 0
        if mixer == "attn":
            layer += attn_params()
        elif mixer == "mamba":
            layer += mamba_params()
        else:
            layer += rwkv_params()
        if ffn in ("mlp", "moe+mlp"):
            layer += mlp_params(cfg.d_ff)
        if ffn in ("moe", "moe+mlp"):
            layer += moe_params(active_only)
        total += layer * cfg.n_periods

    if cfg.encoder_layers:
        total += cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        total += cfg.n_layers * attn_params()      # decoder cross-attention
    return float(total)


def _mixer_flops_per_token(cfg, s: int, causal: bool = True) -> float:
    """Forward token-mixing FLOPs per token beyond the parameter matmuls.

    attention: 2·S·H·hd (QKᵀ) + 2·S·H·hd (PV), halved when causal.
    mamba:     ~9 ops over (di, ds) selective-scan state updates.
    rwkv6:     ~6 ops over (H, hs, hs) state outer-products = 6·d·hs.
    """
    hd = cfg.hd
    attn = 4.0 * s * cfg.n_heads * hd * (0.5 if causal else 1.0)
    di = cfg.d_model * cfg.ssm_expand
    mamba = 9.0 * di * cfg.ssm_d_state
    rwkv = 6.0 * cfg.d_model * cfg.rwkv_head_size
    total = 0.0
    for i in range(cfg.period):
        mixer, _ = cfg.layer_kind(i)
        total += {"attn": attn, "mamba": mamba, "rwkv": rwkv}[mixer]
    total *= cfg.n_periods
    if cfg.encoder_layers:
        total += cfg.encoder_layers * 4.0 * s * cfg.n_heads * hd   # bidir enc
        total += cfg.n_layers * 4.0 * s * cfg.n_heads * hd * 0.5   # cross+self
    return total


def model_flops(cfg, shape, mode: Optional[str] = None) -> float:
    """Useful-work FLOPs for one step (PaLM-style MFU accounting):
    6·N_active·D + 3·mixer terms for training; 2·N_active·D + mixer for
    prefill; per-token decode reads the whole cache once."""
    n_active = count_params(cfg, active_only=True)
    mode = mode or shape.kind
    b, s = shape.global_batch, shape.seq_len
    if mode == "train":
        tokens = b * s
        return 6.0 * n_active * tokens + 3.0 * tokens * \
            _mixer_flops_per_token(cfg, s)
    if mode == "prefill":
        tokens = b * s
        return 2.0 * n_active * tokens + tokens * \
            _mixer_flops_per_token(cfg, s)
    # decode: one token/sequence; attention reads the S-deep cache
    return 2.0 * n_active * b + b * _mixer_flops_per_token(cfg, s)
