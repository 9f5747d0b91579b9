"""repro_torch.kernels — hand-written CUDA kernels for Hopper.

``trq_group_mvm``  the per-128-row-group signed-TRQ matmul with fused A/D
                   op count (port of the Pallas ``trq_group_mvm`` kernel).
``trq_quant``      elementwise TRQ fake-quant and op count (port of the
                   Pallas ``trq_quant`` kernel), and ``trq_score``, which
                   sums the error and ops of a whole table of candidate
                   registers in one launch: Algorithm 1 scores with it.
``xbar_mvm``       the bit-exact sliced crossbar MVM on bit-mask planes,
                   popcount bit-line sums, one conversion each (port of the
                   Pallas ``xbar_mvm`` kernel); backs ``bit_exact``.
``decode_attn``    one-row (decode) attention against a cache, scores and
                   softmax-weighted values in two entries, each sum in an
                   order fixed by one head's shapes (replaces no Pallas
                   kernel: a rank's share of the heads gives the whole
                   call's bits, which cuBLAS's batched products did not).

Each kernel directory has ``kernel.py`` (ctypes wrapper of ``csrc/*.cu``),
``ref.py`` (plain PyTorch version) and ``ops.py`` (dispatch by device).
"""
from .decode_attn import attn_scores, attn_values
from .trq_group_mvm import trq_group_mvm
from .trq_quant import trq_quant
from .xbar_mvm import xbar_mvm
