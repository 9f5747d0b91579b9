"""ctypes wrapper of the CUDA kernel ``csrc/xbar_mvm.cu``.

Replaces ``repro/kernels/xbar_mvm/kernel.py::xbar_mvm_tiles`` (see the
source note in the ``.cu`` file for its bound and design).  The wrapper
checks device, dtype, shape and contiguity, allocates the outputs,
launches on PyTorch's current stream without synchronising, and raises if
the launch was refused.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

LAUNCHES = 0
_MODES = {"twin": 0, "uniform": 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _lib():
    fn = load("xbar_mvm").xbar_mvm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def xbar_mvm_cuda(a_mask: torch.Tensor, w_mask: torch.Tensor,
                  scalars: torch.Tensor, *, n_r1: int = 4, n_r2: int = 4,
                  m: int = 3, nu: int = 1, mode: str = "twin",
                  lossless: bool = False, r_adc: int = 8,
                  per_output: bool = False):
    """a_mask: (k_i, M, G, 4) int32; w_mask: (k_w, G, N, 4) int32; scalars:
    [delta_r1, bias] f32 — all contiguous on one CUDA device.  Returns (acc
    (M, N) f32 before the zero-point correction, ops 0-dim int64 over the
    valid region, per-output ops (M, N) int32 or None)."""
    global LAUNCHES
    for name, t, dt in (("a_mask", a_mask, torch.int32),
                        ("w_mask", w_mask, torch.int32),
                        ("scalars", scalars, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"xbar_mvm: {name} must be a contiguous {dt} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.device != a_mask.device:
            raise ValueError("xbar_mvm: operands on different devices")
    if a_mask.ndim != 4 or w_mask.ndim != 4 or a_mask.shape[3] != 4 or \
            w_mask.shape[3] != 4 or a_mask.shape[2] != w_mask.shape[1]:
        raise ValueError(f"xbar_mvm: masks {tuple(a_mask.shape)} and "
                         f"{tuple(w_mask.shape)} are not (k_i, M, G, 4) "
                         f"and (k_w, G, N, 4)")
    k_i, mm, g, _ = a_mask.shape
    k_w, _, n, _ = w_mask.shape
    if not (1 <= k_i <= 8 and 1 <= k_w <= 8):
        raise ValueError("xbar_mvm: k_i and k_w must lie in 1..8")
    if scalars.numel() != 2:
        raise ValueError("xbar_mvm: scalars must be [delta_r1, bias]")
    if mode not in _MODES:
        raise ValueError(f"xbar_mvm: unknown mode {mode!r}")
    if not all(0 <= r <= 24 for r in (n_r1, n_r2, m)):
        raise ValueError("xbar_mvm: register widths out of range")
    if a_mask.data_ptr() % 16 or w_mask.data_ptr() % 16:
        raise ValueError("xbar_mvm: masks must be 16-byte aligned")
    out = torch.empty((mm, n), dtype=torch.float32, device=a_mask.device)
    ops = torch.zeros((), dtype=torch.int64, device=a_mask.device)
    per = torch.empty((mm, n), dtype=torch.int32, device=a_mask.device) \
        if per_output else None
    if mm == 0 or n == 0:
        return out, ops, per
    fn = _lib()
    with torch.cuda.device(a_mask.device):
        stream = torch.cuda.current_stream(a_mask.device).cuda_stream
        err = fn(a_mask.data_ptr(), w_mask.data_ptr(), scalars.data_ptr(),
                 out.data_ptr(), per.data_ptr() if per is not None else None,
                 ops.data_ptr(), mm, g, n, k_i, k_w, n_r1, n_r2, m, nu,
                 _MODES[mode], int(lossless), r_adc, stream)
    if err != 0:
        raise RuntimeError(f"xbar_mvm launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, ops, per
