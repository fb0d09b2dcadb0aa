from .quant import dense_w8a8, quantize_dino_linears, quantize_linear
from .resize import (
    adaptive_avg_pool2d,
    avg_pool2d,
    interpolate_bicubic,
    interpolate_bilinear,
)

__all__ = [
    "interpolate_bilinear",
    "interpolate_bicubic",
    "adaptive_avg_pool2d",
    "avg_pool2d",
    "quantize_linear",
    "quantize_dino_linears",
    "dense_w8a8",
]
