"""ctypes wrapper of the CUDA kernel ``csrc/trq_group_mvm.cu``.

Replaces ``repro/kernels/trq_group_mvm/kernel.py::trq_group_mvm_tiles``
and, with ``auto_range``, the pre-fit its callers ran before it (see the
source note in the ``.cu`` file for its bound and design).  The wrapper
checks device, dtype, shape and contiguity, allocates the outputs and the
(M, G, N) partial-sum scratch, launches both passes on PyTorch's current
stream without synchronising, and raises if a launch was refused.
``LAUNCHES`` counts the calls (one per call, which covers both passes).

The split launch runs the two passes as two entries, so that ranks each
holding a block of the rows can max-reduce the auto-range cells between
them: :func:`trq_group_mvm_psums_cuda` (pass 1, counted by
``PSUMS_LAUNCHES``) and :func:`trq_group_mvm_quantize_cuda` (pass 2,
``QUANTIZE_LAUNCHES``).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import STATS, XBAR

LAUNCHES = 0
PSUMS_LAUNCHES = 0
QUANTIZE_LAUNCHES = 0
_MODES = {"twin": 0, "uniform": 1}
WEIGHT_DTYPES = (torch.bfloat16, torch.float32)
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 9 + [ctypes.c_void_p])
_PSUMS_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
_QUANTIZE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])


def _entry(name: str, argtypes):
    fn = getattr(load("trq_group_mvm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return _entry("trq_group_mvm_launch", _ARGTYPES)


def _psums_lib():
    return _entry("trq_group_mvm_psums_launch", _PSUMS_ARGTYPES)


def _quantize_lib():
    return _entry("trq_group_mvm_quantize_launch", _QUANTIZE_ARGTYPES)


def _check(name: str, t: torch.Tensor, dtypes, device) -> None:
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous():
        want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"trq_group_mvm: {name} must be a contiguous {want} "
                         f"CUDA tensor, got {t.dtype} on {t.device}")
    if t.device != device:
        raise ValueError("trq_group_mvm: operands on different devices")


def _check_operands(a: torch.Tensor, w: torch.Tensor) -> None:
    _check("a", a, (torch.float32,), a.device)
    _check("w", w, WEIGHT_DTYPES, a.device)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"trq_group_mvm: shapes {tuple(a.shape)} x "
                         f"{tuple(w.shape)} do not contract")
    mm, k = a.shape
    n = w.shape[1]
    if -(-k // XBAR) > 65535 or -(-n // 128) > 65535 or \
            mm * -(-n // 32) >= 2 ** 31:
        raise ValueError(f"trq_group_mvm: {k} x {n} exceeds the launch grid")


def _check_registers(scalars: torch.Tensor, device, n_r1: int, n_r2: int,
                     m: int, mode: str) -> None:
    _check("scalars", scalars, (torch.float32,), device)
    if scalars.numel() != 3:
        raise ValueError("trq_group_mvm: scalars must be [delta_r1, bias, "
                         "grid]")
    if mode not in _MODES:
        raise ValueError(f"trq_group_mvm: unknown mode {mode!r}")
    if not all(0 <= r <= 24 for r in (n_r1, n_r2, m)):
        raise ValueError("trq_group_mvm: register widths out of range")


def trq_group_mvm_cuda(a: torch.Tensor, w: torch.Tensor,
                       scalars: torch.Tensor, *, n_r1: int, n_r2: int,
                       m: int, nu: int = 1, mode: str = "twin",
                       auto_range: bool = False):
    """a: (M, K) f32; w: (K, N) bf16 or f32; scalars: [delta_r1, bias,
    grid] f32, all contiguous on one CUDA device.  With ``auto_range``
    the kernel scales ``delta_r1`` from the call's own max |partial sum|.
    Returns (y (M, N) f32, ops 0-dim int64: the comparator cycles of the
    valid region)."""
    global LAUNCHES
    _check_operands(a, w)
    _check_registers(scalars, a.device, n_r1, n_r2, m, mode)
    mm, k = a.shape
    n = w.shape[1]
    g = -(-k // XBAR)
    if mm == 0 or n == 0 or k == 0:
        return (torch.zeros((mm, n), dtype=torch.float32, device=a.device),
                torch.zeros((), dtype=torch.int64, device=a.device))
    y = torch.empty((mm, n), dtype=torch.float32, device=a.device)
    # [op total, 32 auto-range maximum cells]: zeroed by the launcher
    stats = torch.empty(STATS, dtype=torch.int64, device=a.device)
    part = torch.empty((mm, g, n), dtype=torch.float32, device=a.device)
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
                 scalars.data_ptr(), part.data_ptr(), y.data_ptr(),
                 stats.data_ptr(), mm, k, n, n_r1, n_r2, m, nu, _MODES[mode],
                 int(auto_range), stream)
    if err != 0:
        raise RuntimeError(f"trq_group_mvm launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, stats[0]


def trq_group_mvm_psums_cuda(a: torch.Tensor, w: torch.Tensor):
    """Pass 1 of a split launch: a (M, K) f32 x w (K, N) bf16 or f32 ->
    (part (M, G, N) f32 partial sums, stats (17,) int64 whose words 1..16
    hold the 32 auto-range maximum cells, ``stats[1:].view(torch.int32)``;
    word 0 is zero)."""
    global PSUMS_LAUNCHES
    _check_operands(a, w)
    mm, k = a.shape
    n = w.shape[1]
    if mm == 0 or n == 0 or k == 0:
        raise ValueError("trq_group_mvm: a split launch needs M, K, N >= 1")
    stats = torch.empty(STATS, dtype=torch.int64, device=a.device)
    part = torch.empty((mm, -(-k // XBAR), n), dtype=torch.float32,
                       device=a.device)
    fn = _psums_lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
                 part.data_ptr(), stats.data_ptr(), mm, k, n, stream)
    if err != 0:
        raise RuntimeError(f"trq_group_mvm_psums launch failed: CUDA error "
                           f"{err}")
    PSUMS_LAUNCHES += 1
    return part, stats


def trq_group_mvm_quantize_cuda(part: torch.Tensor, stats: torch.Tensor,
                                scalars: torch.Tensor, k: int, *, n_r1: int,
                                n_r2: int, m: int, nu: int = 1,
                                mode: str = "twin"):
    """Pass 2 of a split launch on pass 1's ``part`` and ``stats`` (its
    cells reduced over the ranks): ``delta_r1`` is fitted to the cells'
    maximum.  ``k`` is the contracted length.  Returns (y (M, N) f32, ops
    0-dim int64, ``stats[0]``)."""
    global QUANTIZE_LAUNCHES
    _check("part", part, (torch.float32,), part.device)
    _check("stats", stats, (torch.int64,), part.device)
    _check_registers(scalars, part.device, n_r1, n_r2, m, mode)
    mm, g, n = part.shape
    if g != -(-k // XBAR) or stats.numel() != STATS:
        raise ValueError("trq_group_mvm: part/stats do not match K")
    y = torch.empty((mm, n), dtype=torch.float32, device=part.device)
    fn = _quantize_lib()
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        err = fn(part.data_ptr(), scalars.data_ptr(), y.data_ptr(),
                 stats.data_ptr(), mm, k, n, n_r1, n_r2, m, nu, _MODES[mode],
                 stream)
    if err != 0:
        raise RuntimeError(f"trq_group_mvm_quantize launch failed: CUDA "
                           f"error {err}")
    QUANTIZE_LAUNCHES += 1
    return y, stats[0]
