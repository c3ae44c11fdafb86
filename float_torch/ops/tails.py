"""The synthesis' StyledConv tails, skip upsamplings and flow merges:
everything a StyledConv runs after its convolution, the 2x-upsampled skip
a level adds to its RGB or flow output with the biases around it, and the
merge of a level's warped feature into its map.  Each is a plain PyTorch
version (the op sequence of ``float_tpu.models.synthesis``) beside a
dispatcher:

- ``styled_tail``  the demodulation, the up conv's 4x4 blur (``up_pad``)
                   and ``fused_leaky_relu``, then the modulation of each
                   conv that reads the output (``modulate``);
- ``skip_tail``    ``fused_leaky_relu`` (ToRGB's), the bias and
                   ``upsample2x(skip)``, added in that order;
- ``flow_merge``   ToFlow's mask applied to the warped feature, the merge
                   with the level's map and the next conv's modulation.

A dispatcher takes K7 (``kernels/csrc/styled_tail.cu``) for channels_last
bf16/f32 maps on a card with the (1, 3, 3, 1) blur, its pad (1, 1) on the
up tail and a skip to add, K8 (``kernels/csrc/flow_merge.cu``) for such
maps, and the plain version for anything else: every CPU tensor, another
layout, dtype or blur.  So a modulation is written by the kernel that
makes the map it scales, or runs as the plain ``x * s`` right after it.
"""
from __future__ import annotations

import torch

from .activations import fused_leaky_relu
from .upfirdn import make_blur_kernel, upfirdn2d, upsample2x

BLUR = (1, 3, 3, 1)          # K7's taps, constants of the kernel
_K7_DTYPES = (torch.bfloat16, torch.float32)


def _on_card(*maps: torch.Tensor) -> bool:
    """The maps are channels_last (B, C, H, W) maps of one bf16/f32 dtype
    on a card: what K7 and K8 take."""
    return (all(m.is_cuda and m.dtype == maps[0].dtype and m.ndim == 4
                and m.is_contiguous(memory_format=torch.channels_last)
                for m in maps)
            and maps[0].dtype in _K7_DTYPES)


def _k7_takes(blur_kernel, *maps: torch.Tensor) -> bool:
    """K7 computes the op for these maps and this blur."""
    return tuple(blur_kernel) == BLUR and _on_card(*maps)


def modulate(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) times ``scale`` (B, C) per frame and channel: a
    modulated conv's input (``ops.modulated.modulation``)."""
    return x * scale[:, :, None, None]


def styled_tail_ref(out: torch.Tensor, demod: torch.Tensor,
                    bias: torch.Tensor, up_pad: tuple | None = None,
                    blur_kernel=BLUR, scale: torch.Tensor | None = None,
                    scale2: torch.Tensor | None = None):
    """Plain version: out (B, C, H, W) times demod (B, C) cast to out's
    dtype, blurred by the up conv's ``upfirdn2d`` at ``up_pad`` (None: no
    blur), then ``fused_leaky_relu(bias)``: y.  Then the modulations of
    the convs that read it: y ``modulate``d by ``scale`` (B, C) where
    given, and with ``scale2`` (B, C) the pair (y, y modulated by scale2),
    y channels_last."""
    out = out * demod.to(out.dtype)[:, :, None, None]
    if up_pad is not None:
        k = make_blur_kernel(blur_kernel, 2, device=out.device)
        out = upfirdn2d(out, k, pad=up_pad)
    y = fused_leaky_relu(out, bias)
    if scale2 is not None:
        y = y.contiguous(memory_format=torch.channels_last)
        y2 = modulate(y, scale2)
    if scale is not None:
        y = modulate(y, scale)
    return y if scale2 is None else (y, y2)


def styled_tail(out: torch.Tensor, demod: torch.Tensor, bias: torch.Tensor,
                up_pad: tuple | None = None, blur_kernel=BLUR,
                scale: torch.Tensor | None = None,
                scale2: torch.Tensor | None = None):
    """A StyledConv's tail after its convolution ``out`` and the
    modulations of the convs that read it (see ``styled_tail_ref``): K7
    (``scale2`` on the plain tail without ``scale``) or the plain
    version."""
    if _k7_takes(blur_kernel, out) and up_pad in (None, (1, 1)) \
            and (scale2 is None or (up_pad is None and scale is None)):
        from ..kernels.styled_tail import styled_tail_cuda
        return styled_tail_cuda(out, demod, bias, up=up_pad is not None,
                                scale=scale, scale2=scale2)
    return styled_tail_ref(out, demod, bias, up_pad, blur_kernel, scale,
                           scale2)


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


def flow_mask(out: torch.Tensor, dtype) -> torch.Tensor:
    """ToFlow's mask sigmoid(out.z) (B, 1, H, W) in ``dtype`` from its raw
    output ``out`` (B, 3, H, W)."""
    return torch.sigmoid(out[:, 2:3].float()).to(dtype)


def flow_merge_ref(warped: torch.Tensor, out: torch.Tensor,
                   x: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None) -> tuple:
    """Plain version: (feat_warp, merged) of a level's warped feature
    ``warped`` (B, C, H, W), ToFlow's raw output ``out`` (B, 3, H, W) and
    the level's map ``x``:

      feat_warp = warped * mask          mask = ``flow_mask(out)``
      merged = modulate(feat_warp + x * (1 - mask), scale)

    merged None without ``scale`` (the last level, where it is dead), and
    x then not read."""
    mask = flow_mask(out, warped.dtype)
    feat_warp = warped * mask
    if scale is None:
        return feat_warp, None
    return feat_warp, modulate(feat_warp + x * (1.0 - mask), scale)


def flow_merge(warped: torch.Tensor, out: torch.Tensor,
               x: torch.Tensor | None = None,
               scale: torch.Tensor | None = None) -> tuple:
    """A level's flow merge (see ``flow_merge_ref``): K8 or the plain
    version."""
    maps = (warped,) if scale is None else (warped, x)
    if _on_card(*maps) and out.device == warped.device \
            and out.dtype == warped.dtype:
        from ..kernels.flow_merge import flow_merge_cuda
        return flow_merge_cuda(warped, out, x, scale)
    return flow_merge_ref(warped, out, x, scale)
