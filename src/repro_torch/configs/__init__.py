from .base import ModelConfig, ShapeConfig, TrainConfig, TRQConfig, SHAPES, \
    LONG_CONTEXT_ARCHS
