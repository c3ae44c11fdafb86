"""Flow-warping StyleGAN2 synthesis decoder + Direction motion basis
(twin of ``float_tpu.models.synthesis``: ``direction`` and the plain
level loop of ``synthesis`` / ``synthesis_cl``).

Param tree (``motion_autoencoder.dec.*`` keys):

    direction.weight                 (512, dim_m)
    input.input                      (1, 512, 4, 4) learned constant
    conv1.{conv.weight, conv.modulation.weight/bias, activate.bias}
    convs.{0..2L-1}.…                StyledConv pairs (even = upsample)
    to_rgbs.{0..L-1}.{conv.0.weight, conv.1.bias, bias}
    to_flows.{0..L-1}.{conv.weight, conv.modulation.weight/bias, bias}

Activations are NCHW tensors held in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is the NHWC-contiguous view the warp kernel
takes without a copy.  Every warp goes through ``warp`` (by default the
``ops.warp.warp_shared`` dispatcher), one shared feature map per level.
"""
from __future__ import annotations

import math

import torch

from ..ops import (equal_conv2d, fused_leaky_relu, identity_grid,
                   modulated_conv2d, upsample2x, warp_shared)

CL = torch.channels_last


def direction(params, alpha):
    """Project motion magnitudes (..., dim_m) onto the QR-orthonormalised
    learned basis: alpha @ Q.T (reference styledecoder.py:428-444).

    Q is computed on the CPU in f32 (LAPACK Householder, the convention
    of the reference and of jnp.linalg.qr), so its column signs do not
    depend on the device's QR."""
    w = params["weight"].detach().float().cpu() + 1e-8
    q, _ = torch.linalg.qr(w)
    return alpha.float() @ q.to(alpha.device).t()


def _styled_conv(x, style, p, up: bool, blur_kernel=(1, 3, 3, 1)):
    """StyledConv: modulated conv (+ optional upsample) -> fused lrelu.
    NoiseInjection is the identity at inference and is omitted."""
    out = modulated_conv2d(
        x, style, p["conv"]["weight"], p["conv"]["modulation"]["weight"],
        p["conv"]["modulation"]["bias"], demodulate=True, up=up,
        blur_kernel=blur_kernel)
    return fused_leaky_relu(out, p["activate"]["bias"].reshape(-1))


def _to_rgb(x, p, skip=None, blur_kernel=(1, 3, 3, 1)):
    """ToRGB: EqualConv2d(k1) + fused lrelu, + bias, + 2x-upsampled skip."""
    out = equal_conv2d(x, p["conv"]["0"]["weight"])
    out = fused_leaky_relu(out, p["conv"]["1"]["bias"].reshape(-1))
    out = out + p["bias"].reshape(1, 3, 1, 1).to(out.dtype)
    if skip is not None:
        out = out + upsample2x(skip, blur_kernel)
    return out


def _to_flow(x, style, feat_nhwc, p, skip=None, warp=warp_shared,
             blur_kernel=(1, 3, 3, 1)):
    """ToFlow: predict (flow xy, mask), warp the shared ``feat_nhwc``
    (1, H, W, C) onto each frame's grid (reference styledecoder.py:399-425):

      sampler = tanh(out[:, 0:2]); mask = sigmoid(out[:, 2:3])
      flow = sampler.xy + identity_grid
      feat_warp = grid_sample(feat, flow) * mask
      merged = feat_warp + x * (1 - mask)

    Returns (feat_warp, merged, raw_out, flow (B, H, W, 2) f32)."""
    out = modulated_conv2d(
        x, style, p["conv"]["weight"], p["conv"]["modulation"]["weight"],
        p["conv"]["modulation"]["bias"], demodulate=False)
    out = out + p["bias"].reshape(1, 3, 1, 1).to(out.dtype)
    if skip is not None:
        out = out + upsample2x(skip, blur_kernel)

    size = x.shape[2]
    sampler = torch.tanh(out[:, 0:2].float())
    mask = torch.sigmoid(out[:, 2:3].float()).to(x.dtype)
    flow = (sampler.permute(0, 2, 3, 1)
            + identity_grid(size, device=x.device)).contiguous()
    warped = warp(feat_nhwc, flow).permute(0, 3, 1, 2)   # NCHW view, CL
    feat_warp = warped * mask
    merged = feat_warp + x * (1.0 - mask)
    return feat_warp, merged, out, flow


def synthesis(params, wa, feats, size: int, warp=warp_shared,
              blur_kernel=(1, 3, 3, 1)):
    """Decode latents into images.

    wa:    (B, style_dim) combined appearance + motion latent (s_r + r_d_t),
           reused for every style slot.
    feats: the 7 encoder skip maps coarse-first, each (1, C, H, W), shared
           by all B frames; cast to wa's dtype.
    warp:  ``warp(feat_nhwc (1, H, W, C), grid (B, H, W, 2)) -> (B, H, W, C)``.

    Returns (img (B, 3, S, S) in about [-1, 1], flow at the 64² level)."""
    dtype = wa.dtype
    b = wa.shape[0]
    n_levels = int(math.log2(size)) - 2            # levels 8² .. size²
    feats_nhwc = [f.to(dtype).contiguous(memory_format=CL).permute(0, 2, 3, 1)
                  for f in feats]

    const = params["input"]["input"]
    out = const.to(dtype).expand(b, -1, -1, -1).contiguous(memory_format=CL)
    out = _styled_conv(out, wa, params["conv1"], up=False,
                       blur_kernel=blur_kernel)

    skip = None
    skip_flow = None
    flow64 = None
    for lvl in range(n_levels):
        out = _styled_conv(out, wa, params["convs"][str(2 * lvl)], up=True,
                           blur_kernel=blur_kernel)
        out = _styled_conv(out, wa, params["convs"][str(2 * lvl + 1)],
                           up=False, blur_kernel=blur_kernel)
        out = out.contiguous(memory_format=CL)
        out_warp, out, skip_flow, fl = _to_flow(
            out, wa, feats_nhwc[lvl], params["to_flows"][str(lvl)],
            skip_flow, warp=warp, blur_kernel=blur_kernel)
        if out.shape[2] == 64:
            flow64 = fl
        skip = _to_rgb(out_warp, params["to_rgbs"][str(lvl)], skip,
                       blur_kernel=blur_kernel)
    return skip, flow64
