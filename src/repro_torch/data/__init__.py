"""repro_torch.data — the synthetic datasets of the paper's evaluation
(``vision_dataset``; the LM ``TokenStream`` comes with training)."""
from .synthetic import vision_dataset
