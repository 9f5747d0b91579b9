"""ctypes wrappers of the CUDA kernel ``csrc/trq_quant.cu``: the elementwise
entry and the scoring entry.

Replaces ``repro/kernels/trq_quant/kernel.py::trq_quant_tiles`` (see the
source note in the ``.cu`` file for its bound and design).  Each wrapper
checks device, dtype, shape and contiguity, allocates the outputs (and the
scoring entry's scratch), launches on PyTorch's current stream without
synchronising, and raises if the launch was refused.  ``LAUNCHES`` counts
the elementwise launches, ``SCORE_LAUNCHES`` the scoring ones.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

LAUNCHES = 0
SCORE_LAUNCHES = 0
MODES = {"twin": 0, "uniform": 1}
# columns of the scoring entry's int32 register table
SCORE_IREGS = ("n_r1", "n_r2", "m", "nu", "mode", "signed")
SCORE_SLICE = 2048     # samples a block scores: kScoreSlice in the .cu
_DTYPES = {torch.float32: 0, torch.float16: 1}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_SCORE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5)


def _bind(name: str, argtypes):
    fn = getattr(load("trq_quant"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return _bind("trq_quant_launch", _ARGTYPES)


def _score_lib():
    return _bind("trq_score_launch", _SCORE_ARGTYPES)


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
    if mode not in MODES:
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
                 MODES[mode], int(signed), stream)
    if err != 0:
        raise RuntimeError(f"trq_quant launch failed: CUDA error {err}")
    LAUNCHES += 1
    return q, ops


def trq_score_cuda(y: torch.Tensor, fregs: torch.Tensor,
                   iregs: torch.Tensor):
    """Score C candidate register sets on the samples ``y`` in one call.

    y: n contiguous f32 or f16 samples on a CUDA device; fregs: (C, 2) f32
    rows [delta_r1, bias]; iregs: (C, 6) int32 rows ``SCORE_IREGS`` (mode
    1 = uniform), both on y's device.  Returns ``(sum_sq, sum_ops)``: per
    candidate the f64 sum of ``(q - y)**2`` (each error squared in f32) and
    the int64 sum of the op counts, reduced in a fixed order."""
    global SCORE_LAUNCHES
    if not y.is_cuda or y.dtype not in _DTYPES or not y.is_contiguous():
        raise ValueError(f"trq_score: y must be a contiguous float32 or "
                         f"float16 CUDA tensor, got {y.dtype} on {y.device}")
    c = fregs.shape[0] if fregs.dim() == 2 else -1
    if fregs.device != y.device or iregs.device != y.device or \
            fregs.dtype != torch.float32 or iregs.dtype != torch.int32 or \
            tuple(fregs.shape) != (c, 2) or \
            tuple(iregs.shape) != (c, len(SCORE_IREGS)):
        raise ValueError("trq_score: the table must be (C, 2) float32 and "
                         "(C, 6) int32 on y's device")
    sum_sq = torch.empty(c, dtype=torch.float64, device=y.device)
    sum_ops = torch.empty(c, dtype=torch.int64, device=y.device)
    n = y.numel()
    if c == 0 or n == 0:
        return sum_sq.zero_(), sum_ops.zero_()
    slices = -(-n // SCORE_SLICE)
    part_sq = torch.empty(c * slices, dtype=torch.float64, device=y.device)
    part_ops = torch.empty(c * slices, dtype=torch.int64, device=y.device)
    fregs, iregs = fregs.contiguous(), iregs.contiguous()
    fn = _score_lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), _DTYPES[y.dtype], n, fregs.data_ptr(),
                 iregs.data_ptr(), c, slices, part_sq.data_ptr(),
                 part_ops.data_ptr(), sum_sq.data_ptr(), sum_ops.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"trq_score launch failed: CUDA error {err}")
    SCORE_LAUNCHES += 1
    return sum_sq, sum_ops
