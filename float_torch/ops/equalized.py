"""Equalized-learning-rate linear / conv (twin of
``float_tpu.ops.equalized``).  Weights keep torch layout: Linear (out, in),
Conv2d (O, I, kH, kW); the runtime scale is 1/sqrt(fan_in)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .activations import fused_leaky_relu


def equal_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, lr_mul: float = 1.0,
                 activation: bool = False) -> torch.Tensor:
    """y = x @ (w * lr_mul / sqrt(in))^T (+ bias * lr_mul), optional
    fused-lrelu activation."""
    scale = (1.0 / math.sqrt(weight.shape[1])) * lr_mul
    out = F.linear(x, (weight * scale).to(x.dtype))
    b = None if bias is None else (bias * lr_mul).to(x.dtype)
    if activation:
        return fused_leaky_relu(out, b)
    if b is not None:
        out = out + b
    return out


def equal_conv2d(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """NCHW conv with runtime weight scale 1/sqrt(I*kH*kW)."""
    o, i, kh, kw = weight.shape
    w = (weight * (1.0 / math.sqrt(i * kh * kw))).to(x.dtype)
    out = F.conv2d(x, w, stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).to(x.dtype)
    return out
