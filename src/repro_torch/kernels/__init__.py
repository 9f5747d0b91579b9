"""repro_torch.kernels — hand-written CUDA kernels for Hopper.

``trq_group_mvm``  the per-128-row-group signed-TRQ matmul with fused A/D
                   op count (port of the Pallas ``trq_group_mvm`` kernel).

Each kernel directory has ``kernel.py`` (ctypes wrapper of ``csrc/*.cu``),
``ref.py`` (plain PyTorch version) and ``ops.py`` (dispatch by device).
"""
from .trq_group_mvm import trq_group_mvm
