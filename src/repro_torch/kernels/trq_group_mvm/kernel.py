"""ctypes wrapper of the CUDA kernel ``csrc/trq_group_mvm.cu``.

Replaces ``repro/kernels/trq_group_mvm/kernel.py::trq_group_mvm_tiles``
(see the source note in the ``.cu`` file for its bound and design).  The
wrapper checks device, dtype, shape and contiguity, allocates the outputs,
launches on PyTorch's current stream without synchronising, and raises if
the launch was refused.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

LAUNCHES = 0
_MODES = {"twin": 0, "uniform": 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def _lib():
    lib = load("trq_group_mvm")
    fn = lib.trq_group_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def trq_group_mvm_cuda(a: torch.Tensor, w: torch.Tensor,
                       scalars: torch.Tensor, *, n_r1: int, n_r2: int,
                       m: int, nu: int = 1, mode: str = "twin"):
    """a: (M, K) f32; w: (K, N) f32; scalars: [delta_r1, bias, grid] f32,
    all contiguous on one CUDA device.  Returns (y (M, N) f32, ops 0-dim
    int64: the comparator cycles of the valid region)."""
    global LAUNCHES
    for name, t in (("a", a), ("w", w), ("scalars", scalars)):
        if not t.is_cuda or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"trq_group_mvm: {name} must be a contiguous "
                             f"float32 CUDA tensor, got {t.dtype} on "
                             f"{t.device}")
        if t.device != a.device:
            raise ValueError("trq_group_mvm: operands on different devices")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"trq_group_mvm: shapes {tuple(a.shape)} x "
                         f"{tuple(w.shape)} do not contract")
    if scalars.numel() != 3:
        raise ValueError("trq_group_mvm: scalars must be [delta_r1, bias, "
                         "grid]")
    if mode not in _MODES:
        raise ValueError(f"trq_group_mvm: unknown mode {mode!r}")
    if not all(0 <= r <= 24 for r in (n_r1, n_r2, m)):
        raise ValueError("trq_group_mvm: register widths out of range")
    mm, k = a.shape
    n = w.shape[1]
    y = torch.empty((mm, n), dtype=torch.float32, device=a.device)
    ops = torch.zeros((), dtype=torch.int64, device=a.device)
    if mm == 0 or n == 0:
        return y, ops
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(), scalars.data_ptr(),
                 y.data_ptr(), ops.data_ptr(), mm, k, n, n_r1, n_r2, m, nu,
                 _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"trq_group_mvm launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, ops
