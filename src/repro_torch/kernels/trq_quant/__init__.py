from .ops import score_table, trq_quant, trq_score
