"""Elementwise activations (twin of ``float_tpu.ops.activations``)."""
from __future__ import annotations

import math

import torch

LRELU_SCALE = math.sqrt(2.0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = LRELU_SCALE) -> torch.Tensor:
    """leaky_relu(x + bias) * scale — StyleGAN2's bias+act+gain op.

    ``bias`` (C,) broadcasts over dim 1 of an NCHW map, or over the last
    dim of (..., F) features.
    """
    if bias is not None:
        if x.ndim == 4 and bias.ndim == 1:
            bias = bias.reshape(1, -1, 1, 1)
        x = x + bias.to(x.dtype)
    return leaky_relu(x, negative_slope) * scale
