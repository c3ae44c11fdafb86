"""Motion-autoencoder image encoder (twin of ``float_tpu.models.encoder``):
a StyleGAN2-style downsampling pyramid plus the 5-layer motion head.

Param tree (``motion_autoencoder.enc.*`` keys):

    net_app.convs.0.0.weight / .1.bias          EqualConv2d(3 -> C, k1)
    net_app.convs.{i}.conv1.0.weight / .1.bias  ResBlock
    net_app.convs.{i}.conv2.1.weight / .2.bias  (blur at .0)
    net_app.convs.{i}.skip.1.weight             (blur at .0)
    net_app.convs.{N}.weight                    final EqualConv2d(k4, no pad)
    fc.{0..4}.weight / .bias                    EqualLinear stack
"""
from __future__ import annotations

import math

from ..ops import (equal_conv2d, equal_linear, fused_leaky_relu,
                   make_blur_kernel, upfirdn2d)

_SQRT2 = math.sqrt(2.0)


def _conv_layer(x, p, kernel_size: int, downsample: bool,
                activate: bool = True, blur_kernel=(1, 3, 3, 1)):
    """ConvLayer: optional FIR blur + stride-2 conv, optional fused lrelu.
    With downsample the conv sits at index 1 (blur at 0), else at 0."""
    if downsample:
        p_len = (len(blur_kernel) - 2) + (kernel_size - 1)
        k = make_blur_kernel(blur_kernel, device=x.device)
        x = upfirdn2d(x, k, pad=((p_len + 1) // 2, p_len // 2))
        conv_idx, stride, padding = 1, 2, 0
    else:
        conv_idx, stride, padding = 0, 1, kernel_size // 2
    conv = p[str(conv_idx)]
    x = equal_conv2d(x, conv["weight"],
                     bias=None if activate else conv.get("bias"),
                     stride=stride, padding=padding)
    if activate:
        x = fused_leaky_relu(x, p[str(conv_idx + 1)]["bias"].reshape(-1))
    return x


def _res_block(x, p):
    """ResBlock: conv1(k3) -> conv2(k3, down) + skip(k1, down), / sqrt(2)."""
    out = _conv_layer(x, p["conv1"], 3, downsample=False)
    out = _conv_layer(out, p["conv2"], 3, downsample=True)
    skip = _conv_layer(x, p["skip"], 1, downsample=True, activate=False)
    return (out + skip) / _SQRT2


def encoder_app(params, x, size: int):
    """Image (B, 3, S, S) in [-1, 1] -> (appearance (B, w_dim), feats):
    the per-level activations coarse-first, 8² … S²."""
    convs = params["convs"]
    res = []
    h = _conv_layer(x, convs["0"], 1, downsample=False)
    res.append(h)
    n_res = int(math.log2(size)) - 2
    for i in range(n_res):
        h = _res_block(h, convs[str(i + 1)])
        res.append(h)
    h = equal_conv2d(h, convs[str(n_res + 1)]["weight"])   # 4x4 -> 1x1
    res.append(h)
    return h.reshape(h.shape[0], -1), res[::-1][2:]


def encoder_fc(params, h):
    """Motion head: 5 EqualLinear layers (w_dim -> ... -> dim_m)."""
    for i in range(5):
        p = params[str(i)]
        h = equal_linear(h, p["weight"], p["bias"])
    return h


def encode_image(params, x, size: int):
    """Returns (appearance s_r, r_s_lambda, feats) (reference
    FLOAT.encode_image_into_latent, FLOAT.py:88-92)."""
    appearance, feats = encoder_app(params["net_app"], x, size)
    return appearance, encoder_fc(params["fc"], appearance), feats
