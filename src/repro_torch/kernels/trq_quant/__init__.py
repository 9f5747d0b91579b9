from .ops import trq_quant
