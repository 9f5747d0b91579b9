"""repro_torch.models — the dense GQA and rwkv6 decoders and the
Whisper-style encoder-decoder as ``nn.Module``s."""
from .registry import ARCHS, build_model, get_config, init
