"""ctypes wrappers of the CUDA kernel ``csrc/decode_attn.cu``: the scores
entry and the values entry of one-row (decode) attention.

Replaces no Pallas kernel (see the source note in the ``.cu`` file for
why it was added, its bound and design).  Each wrapper checks device,
dtype and shape, allocates its output, launches on PyTorch's current
stream without synchronising, and raises if the launch was refused.
``SCORES_LAUNCHES`` and ``VALUES_LAUNCHES`` count the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load

SCORES_LAUNCHES = 0
VALUES_LAUNCHES = 0
MAX_HD = 256                   # kThreads in the .cu
MAX_QUERY = 12288              # G x hd of one head in shared memory
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SCORES_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                    + [ctypes.c_void_p])
_VALUES_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])


def _bind(name: str, argtypes):
    fn = getattr(load("decode_attn"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _scores_lib():
    return _bind("decode_attn_scores_launch", _SCORES_ARGTYPES)


def _values_lib():
    return _bind("decode_attn_values_launch", _VALUES_ARGTYPES)


def _cache(name: str, t: torch.Tensor, like: torch.Tensor):
    """A (B, S, H, hd) cache operand: its dtype code and its strides of b,
    s and h (the head dim must be contiguous)."""
    if not t.is_cuda or t.dtype not in _DTYPES or t.dim() != 4 or \
            t.device != like.device:
        raise ValueError(f"decode_attn: {name} must be a (B, S, H, hd) "
                         f"float32, float16 or bfloat16 CUDA tensor on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if t.stride(3) != 1:
        t = t.contiguous()
    return t, _DTYPES[t.dtype], t.stride()[:3]


def _launch(fn, counter: str, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    if err != 0:
        raise RuntimeError(f"decode_attn {counter} launch failed: CUDA "
                           f"error {err}")


def attn_scores_cuda(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, G, hd) f32; k: (B, S, H, hd).  Returns the scores
    (B, H, G, 1, S) f32, each an fmaf chain over d in order."""
    global SCORES_LAUNCHES
    if not q.is_cuda or q.dtype != torch.float32 or q.dim() != 5 or \
            q.shape[1] != 1:
        raise ValueError(f"decode_attn: q must be a (B, 1, H, G, hd) "
                         f"float32 CUDA tensor, got {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    b, _, h, g, hd = q.shape
    k, code, (sb, ss, sh) = _cache("k", k, q)
    if k.shape[0] != b or k.shape[2:] != (h, hd):
        raise ValueError(f"decode_attn: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if hd > MAX_HD or g * hd > MAX_QUERY:
        raise ValueError(f"decode_attn: a head of G = {g} x hd = {hd} is "
                         f"past the kernel's limits")
    keys = k.shape[1]
    s = torch.empty(b, h, g, 1, keys, dtype=torch.float32, device=q.device)
    if s.numel() == 0:
        return s
    _launch(_scores_lib(), "scores", q.contiguous(), k, code, s, b, h, g,
            hd, keys, sb, ss, sh)
    SCORES_LAUNCHES += 1
    return s


def attn_values_cuda(s: torch.Tensor, v: torch.Tensor, lens=None,
                     round_a: bool = False) -> torch.Tensor:
    """s: (B, H, G, 1, S) f32; v: (B, S, H, hd); lens: (B,) valid keys or
    None (all).  Returns the softmax-weighted values (B, 1, H, G, hd)
    f32."""
    global VALUES_LAUNCHES
    if not s.is_cuda or s.dtype != torch.float32 or s.dim() != 5 or \
            s.shape[3] != 1:
        raise ValueError(f"decode_attn: s must be a (B, H, G, 1, S) float32 "
                         f"CUDA tensor, got {tuple(s.shape)} {s.dtype} on "
                         f"{s.device}")
    b, h, g, _, keys = s.shape
    v, code, (sb, ss, sh) = _cache("v", v, s)
    hd = v.shape[3]
    if tuple(v.shape[:3]) != (b, keys, h) or hd > MAX_HD:
        raise ValueError(f"decode_attn: v {tuple(v.shape)} does not match "
                         f"s {tuple(s.shape)} (or hd past {MAX_HD})")
    if lens is not None:
        lens = torch.as_tensor(lens, device=s.device).to(
            torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"decode_attn: lens must be ({b},)")
    o = torch.empty(b, 1, h, g, hd, dtype=torch.float32, device=s.device)
    if o.numel() == 0:
        return o
    _launch(_values_lib(), "values", s.contiguous(), v, code,
            0 if lens is None else lens, o, b, h, g, hd, keys, sb, ss, sh,
            int(round_a))
    VALUES_LAUNCHES += 1
    return o
