"""Modulated (style-conditioned) convolution — StyleGAN2's core op (twin of
``float_tpu.ops.modulated``).

Input/output-scaling form: modulation scales the conv INPUT per
(batch, in-channel) and demodulation scales the conv OUTPUT per
(batch, out-channel), so the conv itself is one batched conv with the
shared weight.  demod[b, o] = rsqrt(sum_i (sum_k w[o,i,k]^2) s[b,i]^2 + eps).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .equalized import equal_linear
from .tails import styled_tail
from .upfirdn import make_blur_kernel, upfirdn2d

_EPS = 1e-8


def _modulate(x, style, weight, mod_weight, mod_bias, demodulate: bool):
    """The modulated input xm (B, I, H, W), the conv weight (O, I, kH, kW)
    in x's dtype and the f32 demodulation (B, O), or None."""
    in_c = x.shape[1]
    _, out_c, _, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(in_c * kh * kw)

    s = equal_linear(style, mod_weight, mod_bias)             # (B, I)
    w0 = weight[0]                                            # (O, I, kH, kW)
    demod = None
    if demodulate:
        w2 = ((w0.float() * scale) ** 2).sum(dim=(2, 3))      # (O, I)
        demod = torch.rsqrt(s.float() ** 2 @ w2.t() + _EPS)   # (B, O)

    xm = x * (s * scale).to(x.dtype)[:, :, None, None]
    return xm, w0.to(x.dtype), demod


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
    kh = weight.shape[-2]
    xm, cw, demod = _modulate(x, style, weight, mod_weight, mod_bias,
                              demodulate)

    def _demod(out):
        if demod is None:
            return out
        return out * demod.to(x.dtype)[:, :, None, None]

    factor = 2
    if up:
        out = _demod(F.conv_transpose2d(xm, cw.transpose(0, 1), stride=2))
        k = make_blur_kernel(blur_kernel, factor, device=x.device)
        return upfirdn2d(out, k, pad=_up_pad(kh, blur_kernel, factor))
    if down:
        p = (len(blur_kernel) - factor) + (kh - 1)
        k = make_blur_kernel(blur_kernel, device=x.device)
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
    kh = weight.shape[-2]
    xm, cw, demod = _modulate(x, style, weight, mod_weight, mod_bias, True)
    if up:
        out = F.conv_transpose2d(xm, cw.transpose(0, 1), stride=2)
        return styled_tail(out, demod, bias, _up_pad(kh, blur_kernel),
                           blur_kernel)
    return styled_tail(F.conv2d(xm, cw, padding=kh // 2), demod, bias,
                       blur_kernel=blur_kernel)
