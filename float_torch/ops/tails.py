"""The synthesis' StyledConv tails and skip upsamplings: everything a
StyledConv runs after its convolution, and the 2x-upsampled skip a level
adds to its RGB or flow output with the biases around it.  Each is a plain
PyTorch version (the op sequence of ``float_tpu.models.synthesis``) beside
a dispatcher:

- ``styled_tail``  the demodulation, the up conv's 4x4 blur (``up_pad``)
                   and ``fused_leaky_relu``;
- ``skip_tail``    ``fused_leaky_relu`` (ToRGB's), the bias and
                   ``upsample2x(skip)``, added in that order.

A dispatcher takes K7 (``kernels/csrc/styled_tail.cu``) for channels_last
bf16/f32 maps on a card with the (1, 3, 3, 1) blur, its pad (1, 1) on the
up tail and a skip to add, and the plain version for anything else: every
CPU tensor, another layout, dtype or blur.
"""
from __future__ import annotations

import torch

from .activations import fused_leaky_relu
from .upfirdn import make_blur_kernel, upfirdn2d, upsample2x

BLUR = (1, 3, 3, 1)          # K7's taps, constants of the kernel
_K7_DTYPES = (torch.bfloat16, torch.float32)


def _k7_takes(blur_kernel, *maps: torch.Tensor) -> bool:
    """K7 computes the op for these maps and this blur."""
    return (tuple(blur_kernel) == BLUR
            and all(m.is_cuda and m.dtype == maps[0].dtype and m.ndim == 4
                    and m.is_contiguous(memory_format=torch.channels_last)
                    for m in maps)
            and maps[0].dtype in _K7_DTYPES)


def styled_tail_ref(out: torch.Tensor, demod: torch.Tensor,
                    bias: torch.Tensor, up_pad: tuple | None = None,
                    blur_kernel=BLUR) -> torch.Tensor:
    """Plain version: out (B, C, H, W) times demod (B, C) cast to out's
    dtype, blurred by the up conv's ``upfirdn2d`` at ``up_pad`` (None: no
    blur), then ``fused_leaky_relu(bias)``."""
    out = out * demod.to(out.dtype)[:, :, None, None]
    if up_pad is not None:
        k = make_blur_kernel(blur_kernel, 2, device=out.device)
        out = upfirdn2d(out, k, pad=up_pad)
    return fused_leaky_relu(out, bias)


def styled_tail(out: torch.Tensor, demod: torch.Tensor, bias: torch.Tensor,
                up_pad: tuple | None = None,
                blur_kernel=BLUR) -> torch.Tensor:
    """A StyledConv's tail after its convolution ``out`` (see
    ``styled_tail_ref``): K7 or the plain version."""
    if _k7_takes(blur_kernel, out) and up_pad in (None, (1, 1)):
        from ..kernels.styled_tail import styled_tail_cuda
        return styled_tail_cuda(out, demod, bias, up=up_pad is not None)
    return styled_tail_ref(out, demod, bias, up_pad, blur_kernel)


def skip_tail_ref(x: torch.Tensor, skip: torch.Tensor | None,
                  bias: torch.Tensor, act_bias: torch.Tensor | None = None,
                  blur_kernel=BLUR) -> torch.Tensor:
    """Plain version: ``fused_leaky_relu(x, act_bias)`` (with act_bias),
    + bias (C values), + ``upsample2x(skip)`` (with a skip)."""
    if act_bias is not None:
        x = fused_leaky_relu(x, act_bias)
    x = x + bias.reshape(1, -1, 1, 1).to(x.dtype)
    if skip is not None:
        x = x + upsample2x(skip, blur_kernel)
    return x


def skip_tail(x: torch.Tensor, skip: torch.Tensor | None, bias: torch.Tensor,
              act_bias: torch.Tensor | None = None,
              blur_kernel=BLUR) -> torch.Tensor:
    """A level's RGB or flow output ``x`` with its biases and the previous
    level's upsampled ``skip`` (see ``skip_tail_ref``): K7 or the plain
    version."""
    if skip is not None and _k7_takes(blur_kernel, x, skip):
        from ..kernels.styled_tail import skip_tail_cuda
        return skip_tail_cuda(x, skip, bias, act_bias)
    return skip_tail_ref(x, skip, bias, act_bias, blur_kernel)
