"""repro_torch.runtime — the front door: ``compile(cfg, state)`` returns a
:class:`Runtime` whose entry points each return ``(out, AdOpsReport)``."""
from .runtime import (TRAIN_BACKENDS, AdOpsReport, Runtime, compile,
                      resolve_device)

__all__ = ["AdOpsReport", "Runtime", "TRAIN_BACKENDS", "compile",
           "resolve_device"]
