"""repro_torch.models — the dense GQA decoder as ``nn.Module``s."""
from .registry import ARCHS, build_model, get_config, init
