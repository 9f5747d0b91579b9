"""Per-arch training configuration (port of the train-config part of
``repro.launch.steps``).  ``build_train_cell``, ``build_serve_cell`` and
the rest, which lower a step for a production mesh, wait for the
multi-GPU port."""
from __future__ import annotations

from ..configs.base import TrainConfig

# per-arch training overrides (the optimizer-state tricks the large archs
# need to fit)
TRAIN_OVERRIDES: dict = {
    # 480B params: f32 master + bf16-m + factored-v + ZeRO-1 ≈ 11 GB/chip
    "arctic-480b": dict(optimizer_dtype="bfloat16",
                        factored_second_moment=True),
    "internvl2-76b": dict(optimizer_dtype="bfloat16"),
    "deepseek-67b": dict(optimizer_dtype="bfloat16"),
}


def make_train_config(arch: str, **kw) -> TrainConfig:
    over = dict(TRAIN_OVERRIDES.get(arch, {}))
    over.update(kw)
    return TrainConfig(**over)
