"""repro_torch.models — the dense GQA, MoE, rwkv6 and mamba/attention
hybrid (jamba) decoders and the Whisper-style encoder-decoder as
``nn.Module``s."""
from .registry import ARCHS, build_model, get_config, init, list_archs
