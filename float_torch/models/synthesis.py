"""Flow-warping StyleGAN2 synthesis decoder + Direction motion basis
(twin of ``float_tpu.models.synthesis``: ``direction`` and the level loop
of ``synthesis`` / ``synthesis_cl``).

Param tree (``motion_autoencoder.dec.*`` keys):

    direction.weight                 (512, dim_m)
    input.input                      (1, 512, 4, 4) learned constant
    conv1.{conv.weight, conv.modulation.weight/bias, activate.bias}
    convs.{0..2L-1}.…                StyledConv pairs (even = upsample)
    to_rgbs.{0..L-1}.{conv.0.weight, conv.1.bias, bias}
    to_flows.{0..L-1}.{conv.weight, conv.modulation.weight/bias, bias}

Activations are NCHW tensors held in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is the NHWC-contiguous view the warp kernels
take without a copy.  Each level warps its encoder map by the frames'
flows through ``warps`` (``ops.warp.DISPATCH`` by default):

- a map of batch 1 under a frame batch above 1 is shared by the frames
  (``warps.shared``, K1);
- any other map is warped frame by frame (``warps.per_frame``, K3): a
  one-frame decode chunk, or maps of batch B.

With ``rgb_in_kernel`` the last level, when shared, warps and contracts
its 1×1 ToRGB in one kernel (``warps.rgb``, K2), so its (B, S, S, C)
warped map is never stored (``float_tpu``'s ``_packed_warp_rgb`` with
``RGB_IN_KERNEL``).
"""
from __future__ import annotations

import math

import torch

from ..ops import (DISPATCH, Warps, equal_conv2d, fused_leaky_relu,
                   identity_grid, modulated_conv2d, upsample2x)

CL = torch.channels_last

# Default of ``synthesis(rgb_in_kernel=)``: the last level's warp and 1×1
# ToRGB as one kernel (K2) instead of the warp (K1) and a convolution.
RGB_IN_KERNEL = False


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


def _rgb_tail(out, p, skip, blur_kernel):
    """ToRGB after its 1×1 conv: fused lrelu, + bias, + 2x-upsampled skip."""
    out = fused_leaky_relu(out, p["conv"]["1"]["bias"].reshape(-1))
    out = out + p["bias"].reshape(1, 3, 1, 1).to(out.dtype)
    if skip is not None:
        out = out + upsample2x(skip, blur_kernel)
    return out


def _to_rgb(x, p, skip=None, blur_kernel=(1, 3, 3, 1)):
    """ToRGB: EqualConv2d(k1) + fused lrelu, + bias, + 2x-upsampled skip."""
    return _rgb_tail(equal_conv2d(x, p["conv"]["0"]["weight"]), p, skip,
                     blur_kernel)


def _flow_pred(x, style, p, skip, blur_kernel):
    """ToFlow's prediction: raw out (B, 3, H, W), flow (B, H, W, 2) f32
    (tanh(out.xy) + the identity grid) and mask sigmoid(out.z) in x's
    dtype (reference styledecoder.py:399-425)."""
    out = modulated_conv2d(
        x, style, p["conv"]["weight"], p["conv"]["modulation"]["weight"],
        p["conv"]["modulation"]["bias"], demodulate=False)
    out = out + p["bias"].reshape(1, 3, 1, 1).to(out.dtype)
    if skip is not None:
        out = out + upsample2x(skip, blur_kernel)
    sampler = torch.tanh(out[:, 0:2].float())
    mask = torch.sigmoid(out[:, 2:3].float()).to(x.dtype)
    flow = (sampler.permute(0, 2, 3, 1)
            + identity_grid(x.shape[2], device=x.device)).contiguous()
    return out, flow, mask


def _is_shared(feat_nhwc, b: int) -> bool:
    """float_tpu's ``_to_flow_cl`` rule: one map under several frames."""
    return feat_nhwc.shape[0] == 1 and b != 1


def _to_flow(x, style, feat_nhwc, p, skip=None, warps: Warps = DISPATCH,
             blur_kernel=(1, 3, 3, 1)):
    """ToFlow: predict (flow xy, mask), warp ``feat_nhwc`` (1 or B, H, W, C)
    onto each frame's grid (reference styledecoder.py:399-425):

      feat_warp = grid_sample(feat, flow) * mask
      merged = feat_warp + x * (1 - mask)

    Returns (feat_warp, merged, raw_out, flow (B, H, W, 2) f32)."""
    out, flow, mask = _flow_pred(x, style, p, skip, blur_kernel)
    warp = warps.shared if _is_shared(feat_nhwc, x.shape[0]) \
        else warps.per_frame
    warped = warp(feat_nhwc, flow).permute(0, 3, 1, 2)   # NCHW view, CL
    feat_warp = warped * mask
    merged = feat_warp + x * (1.0 - mask)
    return feat_warp, merged, out, flow


def _to_flow_rgb(x, style, feat_nhwc, p_flow, p_rgb, skip_flow, skip_rgb,
                 warps: Warps = DISPATCH, blur_kernel=(1, 3, 3, 1)):
    """The last level's ToFlow + ToRGB with the warp and the 1×1 conv in
    one kernel.  The merged feature is dead at the last level and the 1×1
    conv is linear over channels, so conv(warp · mask) = mask · conv(warp)
    (float_tpu ``_packed_warp_rgb``).  Returns (rgb, flow)."""
    out, flow, mask = _flow_pred(x, style, p_flow, skip_flow, blur_kernel)
    c = feat_nhwc.shape[-1]
    w0 = p_rgb["conv"]["0"]["weight"].float()             # (3, C, 1, 1)
    wk = (w0[:, :, 0, 0] * (1.0 / math.sqrt(c))).contiguous()
    rgb = warps.rgb(feat_nhwc, flow, wk).permute(0, 3, 1, 2) * mask
    return _rgb_tail(rgb, p_rgb, skip_rgb, blur_kernel), flow


def synthesis(params, wa, feats, size: int, warps: Warps = DISPATCH,
              rgb_in_kernel: bool = RGB_IN_KERNEL, blur_kernel=(1, 3, 3, 1)):
    """Decode latents into images.

    wa:    (B, style_dim) combined appearance + motion latent (s_r + r_d_t),
           reused for every style slot.
    feats: the 7 encoder skip maps coarse-first, each (1, C, H, W) shared
           by all B frames, or (B, C, H, W); cast to wa's dtype.
    warps: the three warp forms (``ops.warp.Warps``).
    rgb_in_kernel: contract the last level's ToRGB inside its warp when
           that level is shared (K2).

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
        feat_l = feats_nhwc[lvl]
        if (rgb_in_kernel and lvl == n_levels - 1
                and _is_shared(feat_l, b)):
            skip, fl = _to_flow_rgb(
                out, wa, feat_l, params["to_flows"][str(lvl)],
                params["to_rgbs"][str(lvl)], skip_flow, skip, warps=warps,
                blur_kernel=blur_kernel)
        else:
            out_warp, out, skip_flow, fl = _to_flow(
                out, wa, feat_l, params["to_flows"][str(lvl)], skip_flow,
                warps=warps, blur_kernel=blur_kernel)
            skip = _to_rgb(out_warp, params["to_rgbs"][str(lvl)], skip,
                           blur_kernel=blur_kernel)
        if out.shape[2] == 64:
            flow64 = fl
    return skip, flow64
