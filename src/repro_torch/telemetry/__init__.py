"""repro_torch.telemetry — the serving energy report (``serve_report``).

The reference's XLA-HLO parser (``telemetry/hlo.py``) has no PyTorch
counterpart and is not ported; its TPU roofline waits for an H100 one."""
from .serve_report import format_energy_report, request_rows, serve_report

__all__ = ["format_energy_report", "request_rows", "serve_report"]
