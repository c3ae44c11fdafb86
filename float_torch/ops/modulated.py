"""Modulated (style-conditioned) convolution — StyleGAN2's core op (twin of
``float_tpu.ops.modulated``).

Input/output-scaling form: modulation scales the conv INPUT per
(batch, in-channel) and demodulation scales the conv OUTPUT per
(batch, out-channel), so the conv itself is one batched conv with the
shared weight.  demod[b, o] = rsqrt(sum_i (sum_k w[o,i,k]^2) s[b,i]^2 + eps).

Both depend on the style alone (``modulation``), so a caller that knows
its styles ahead may have the kernel that makes a conv's input write it
already modulated (``ops.tails``) and pass it to the ``*_pre`` forms,
which skip the ``x * s`` pass.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .equalized import equal_linear
from .tails import modulate, styled_tail
from .upfirdn import make_blur_kernel, upfirdn2d

_EPS = 1e-8


class Modulation(NamedTuple):
    """A modulated conv's style terms: ``scale`` (B, I) in the maps' dtype,
    the multiplier of its input (s / sqrt(I kH kW)); ``demod`` (B, O) f32,
    or None without demodulation."""
    scale: torch.Tensor
    demod: torch.Tensor | None


def modulation(style, weight, mod_weight, mod_bias, demodulate: bool,
               dtype) -> Modulation:
    """The ``Modulation`` of the conv ``weight`` (1, O, I, kH, kW) under
    ``style`` (B, style_dim), its scale in ``dtype``."""
    _, out_c, in_c, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(in_c * kh * kw)

    s = equal_linear(style, mod_weight, mod_bias)             # (B, I)
    demod = None
    if demodulate:
        w2 = ((weight[0].float() * scale) ** 2).sum(dim=(2, 3))   # (O, I)
        demod = torch.rsqrt(s.float() ** 2 @ w2.t() + _EPS)   # (B, O)
    return Modulation((s * scale).to(dtype), demod)


def _up_pad(kh: int, blur_kernel, factor: int = 2) -> tuple:
    """upfirdn2d's pad of the blur after a stride-2 transposed conv."""
    p = (len(blur_kernel) - factor) - (kh - 1)
    return (p + 1) // 2 + factor - 1, p // 2 + 1


def modulated_conv2d(x: torch.Tensor,            # (B, I, H, W)
                     style: torch.Tensor,        # (B, style_dim)
                     weight: torch.Tensor,       # (1, O, I, kH, kW)
                     mod_weight: torch.Tensor,   # (I, style_dim)
                     mod_bias: torch.Tensor,     # (I,)
                     demodulate: bool = True, up: bool = False,
                     down: bool = False,
                     blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """StyleGAN2 ModulatedConv2d: padding k//2 on the plain path,
    conv_transpose (stride 2) + blur for ``up``, blur + stride-2 conv for
    ``down``."""
    mod = modulation(style, weight, mod_weight, mod_bias, demodulate,
                     x.dtype)
    return modulated_conv2d_pre(modulate(x, mod.scale), mod.demod, weight,
                                up=up, down=down, blur_kernel=blur_kernel)


def modulated_conv2d_pre(xm: torch.Tensor, demod: torch.Tensor | None,
                         weight: torch.Tensor, up: bool = False,
                         down: bool = False,
                         blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """``modulated_conv2d`` of an input already modulated, ``xm``, with its
    ``Modulation``'s ``demod``."""
    kh = weight.shape[-2]
    cw = weight[0].to(xm.dtype)

    def _demod(out):
        if demod is None:
            return out
        return out * demod.to(xm.dtype)[:, :, None, None]

    factor = 2
    if up:
        out = _demod(F.conv_transpose2d(xm, cw.transpose(0, 1), stride=2))
        k = make_blur_kernel(blur_kernel, factor, device=xm.device)
        return upfirdn2d(out, k, pad=_up_pad(kh, blur_kernel, factor))
    if down:
        p = (len(blur_kernel) - factor) + (kh - 1)
        k = make_blur_kernel(blur_kernel, device=xm.device)
        xm = upfirdn2d(xm, k, pad=((p + 1) // 2, p // 2))
        return _demod(F.conv2d(xm, cw, stride=2))
    return _demod(F.conv2d(xm, cw, padding=kh // 2))


def styled_conv2d(x: torch.Tensor, style: torch.Tensor, weight: torch.Tensor,
                  mod_weight: torch.Tensor, mod_bias: torch.Tensor,
                  bias: torch.Tensor, up: bool = False,
                  blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """StyleGAN2's StyledConv: the demodulated ``modulated_conv2d`` (with
    ``up``: its transposed conv and blur), then ``fused_leaky_relu(bias)``.
    Everything after the convolution is ``styled_tail``: one K7 pass on a
    card's channels_last maps, the plain ops otherwise."""
    mod = modulation(style, weight, mod_weight, mod_bias, True, x.dtype)
    return styled_conv2d_pre(modulate(x, mod.scale), mod.demod, weight, bias,
                             up=up, blur_kernel=blur_kernel)


def styled_conv2d_pre(xm: torch.Tensor, demod: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor,
                      up: bool = False, blur_kernel=(1, 3, 3, 1),
                      scale: torch.Tensor | None = None,
                      scale2: torch.Tensor | None = None):
    """``styled_conv2d`` of an input already modulated, ``xm``, with its
    ``Modulation``'s ``demod``.  ``scale`` and ``scale2``, the
    modulations of the convs that read the output, go to ``styled_tail``:
    the output comes back modulated by ``scale``, and with ``scale2`` as
    the pair (output, output modulated by scale2)."""
    kh = weight.shape[-2]
    cw = weight[0].to(xm.dtype)
    if up:
        out = F.conv_transpose2d(xm, cw.transpose(0, 1), stride=2)
        return styled_tail(out, demod, bias, _up_pad(kh, blur_kernel),
                           blur_kernel, scale=scale, scale2=scale2)
    return styled_tail(F.conv2d(xm, cw, padding=kh // 2), demod, bias,
                       blur_kernel=blur_kernel, scale=scale, scale2=scale2)
