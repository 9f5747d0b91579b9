from .ops import attn_scores, attn_values
