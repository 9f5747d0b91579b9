"""repro_torch.telemetry — the serving energy report (``serve_report``)
and the roofline of a step against one H100 (``roofline``).

The reference's XLA-HLO parser (``telemetry/hlo.py``) has no PyTorch
counterpart: the port has no HLO; the dry run counts FLOPs over aten
operations instead."""
from .roofline import (H100, HwSpec, RooflineReport, count_params,
                       model_flops, roofline)
from .serve_report import format_energy_report, request_rows, serve_report

__all__ = ["format_energy_report", "request_rows", "serve_report", "H100",
           "HwSpec", "RooflineReport", "count_params", "model_flops",
           "roofline"]
