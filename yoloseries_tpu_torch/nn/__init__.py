from .layers import (
    BasicBottleneck,
    BatchNorm,
    C3BottleneckCSP,
    ConvBnAct,
    DetectHead,
    FastSPP,
    detect_bias_init,
    max_pool_same,
    upsample2x,
)

__all__ = [
    "BasicBottleneck",
    "BatchNorm",
    "C3BottleneckCSP",
    "ConvBnAct",
    "DetectHead",
    "FastSPP",
    "detect_bias_init",
    "max_pool_same",
    "upsample2x",
]
