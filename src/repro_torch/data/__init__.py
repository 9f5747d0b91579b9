"""repro_torch.data — the synthetic datasets: the LM ``TokenStream``
(and ``lm_batch``, one of its batches) and the paper's ``vision_dataset``."""
from .synthetic import TokenStream, lm_batch, vision_dataset
