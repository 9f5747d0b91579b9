"""ctypes wrapper of the CUDA kernel ``csrc/trq_quant.cu``.

Replaces ``repro/kernels/trq_quant/kernel.py::trq_quant_tiles`` (see the
source note in the ``.cu`` file for its bound and design).  The wrapper
checks device, dtype and contiguity, allocates the outputs, launches on
PyTorch's current stream without synchronising, and raises if the launch
was refused.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

LAUNCHES = 0
_MODES = {"twin": 0, "uniform": 1}
_DTYPES = {torch.float32: 0, torch.float16: 1}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _lib():
    fn = load("trq_quant").trq_quant_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def trq_quant_cuda(x: torch.Tensor, scalars: torch.Tensor, *, n_r1: int,
                   n_r2: int, m: int, nu: int = 1, mode: str = "twin",
                   signed: bool = False):
    """x: contiguous f32 or f16 CUDA tensor of any shape; scalars:
    [delta_r1, bias] f32 on the same device.  Returns (q f32, ops int32),
    both with x's shape."""
    global LAUNCHES
    if not x.is_cuda or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"trq_quant: x must be a contiguous float32 or "
                         f"float16 CUDA tensor, got {x.dtype} on {x.device}")
    if not scalars.is_cuda or scalars.dtype != torch.float32 or \
            scalars.numel() != 2 or scalars.device != x.device:
        raise ValueError("trq_quant: scalars must be [delta_r1, bias] "
                         "float32 on x's device")
    if mode not in _MODES:
        raise ValueError(f"trq_quant: unknown mode {mode!r}")
    if not all(0 <= r <= 24 for r in (n_r1, n_r2, m)):
        raise ValueError("trq_quant: register widths out of range")
    q = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    ops = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return q, ops
    scalars = scalars.contiguous()
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), _DTYPES[x.dtype], scalars.data_ptr(),
                 q.data_ptr(), ops.data_ptr(), x.numel(), n_r1, n_r2, m, nu,
                 _MODES[mode], int(signed), stream)
    if err != 0:
        raise RuntimeError(f"trq_quant launch failed: CUDA error {err}")
    LAUNCHES += 1
    return q, ops
