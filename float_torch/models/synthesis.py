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

Everything a StyledConv runs after its convolution, and each level's
2x-upsampled skip with the biases around it, goes through ``ops.tails``:
one K7 pass (``kernels/csrc/styled_tail.cu``) on a card's channels_last
maps, the plain ops elsewhere; so does each level's flow merge (K8,
``kernels/csrc/flow_merge.cu``).  Every modulated conv's style terms
depend on the latents alone and are computed up front (``_modulations``),
so each conv's input is written already modulated by whatever makes it:
conv1's tail (level 0's up conv), an up tail (the plain conv), a plain
tail's second output (ToFlow) and the previous level's merge (the up
conv).  Off the card each modulation runs as the plain ``x * s`` right
after the op that makes its input: the same products, bit for bit, as a
synthesis whose convs modulate their own inputs.

With ``rgb_in_kernel`` the last level, when shared, warps and contracts
its 1×1 ToRGB in one kernel (``warps.rgb``, K2), so its (B, S, S, C)
warped map is never stored (``float_tpu``'s ``_packed_warp_rgb`` with
``RGB_IN_KERNEL``).
"""
from __future__ import annotations

import math

import torch

from ..ops import (DISPATCH, Warps, equal_conv2d, identity_grid, skip_tail)
from ..ops.modulated import (modulated_conv2d_pre, modulation,
                             styled_conv2d_pre)
from ..ops.tails import flow_mask, flow_merge, modulate

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


def _modulation(p, wa, demodulate: bool = True):
    """The ``Modulation`` of the modulated conv ``p["conv"]`` under wa."""
    c = p["conv"]
    return modulation(wa, c["weight"], c["modulation"]["weight"],
                      c["modulation"]["bias"], demodulate, wa.dtype)


def _modulations(params, wa, n_levels: int) -> tuple:
    """Every modulated conv's ``Modulation`` of a decode, from wa alone:
    conv1's, then each level's (up conv, plain conv, ToFlow)."""
    return _modulation(params["conv1"], wa), [
        (_modulation(params["convs"][str(2 * lvl)], wa),
         _modulation(params["convs"][str(2 * lvl + 1)], wa),
         _modulation(params["to_flows"][str(lvl)], wa, demodulate=False))
        for lvl in range(n_levels)]


def _styled_conv(xm, mod, p, up: bool, blur_kernel=(1, 3, 3, 1),
                 scale=None, scale2=None):
    """StyledConv of an input already modulated by ``mod`` (modulated conv
    (+ optional upsample) -> fused lrelu), its output modulated by
    ``scale`` / also by ``scale2`` (``styled_conv2d_pre``).
    NoiseInjection is the identity at inference and is omitted."""
    return styled_conv2d_pre(
        xm, mod.demod, p["conv"]["weight"], p["activate"]["bias"].reshape(-1),
        up=up, blur_kernel=blur_kernel, scale=scale, scale2=scale2)


def _rgb_tail(out, p, skip, blur_kernel):
    """ToRGB after its 1×1 conv: fused lrelu, + bias, + 2x-upsampled skip."""
    return skip_tail(out, skip, p["bias"].reshape(-1),
                     act_bias=p["conv"]["1"]["bias"].reshape(-1),
                     blur_kernel=blur_kernel)


def _to_rgb(x, p, skip=None, blur_kernel=(1, 3, 3, 1)):
    """ToRGB: EqualConv2d(k1) + fused lrelu, + bias, + 2x-upsampled skip."""
    return _rgb_tail(equal_conv2d(x, p["conv"]["0"]["weight"]), p, skip,
                     blur_kernel)


def _flow_pred(xm, p, skip, blur_kernel):
    """ToFlow's prediction from its input already modulated, ``xm``: raw
    out (B, 3, H, W) and flow (B, H, W, 2) f32 (tanh(out.xy) + the
    identity grid); its mask is ``flow_mask(out)`` (reference
    styledecoder.py:399-425)."""
    out = modulated_conv2d_pre(xm, None, p["conv"]["weight"])
    out = skip_tail(out, skip, p["bias"].reshape(-1), blur_kernel=blur_kernel)
    sampler = torch.tanh(out[:, 0:2].float())
    flow = (sampler.permute(0, 2, 3, 1)
            + identity_grid(xm.shape[2], device=xm.device)).contiguous()
    return out, flow


def _is_shared(feat_nhwc, b: int) -> bool:
    """float_tpu's ``_to_flow_cl`` rule: one map under several frames."""
    return feat_nhwc.shape[0] == 1 and b != 1


def _to_flow(x, xm, feat_nhwc, p, skip=None, scale=None,
             warps: Warps = DISPATCH, blur_kernel=(1, 3, 3, 1)):
    """ToFlow of the level's map ``x``, whose input ``xm`` is x already
    modulated: predict (flow xy, mask), warp ``feat_nhwc`` (1 or B, H, W,
    C) onto each frame's grid (reference styledecoder.py:399-425):

      feat_warp = grid_sample(feat, flow) * mask
      merged = feat_warp + x * (1 - mask)

    merged comes back modulated by ``scale``, the next level's up conv's;
    without it (the last level) merged is None and x, which may be None,
    is not read.  Returns (feat_warp, merged, raw_out, flow (B, H, W, 2)
    f32)."""
    out, flow = _flow_pred(xm, p, skip, blur_kernel)
    warp = warps.shared if _is_shared(feat_nhwc, xm.shape[0]) \
        else warps.per_frame
    warped = warp(feat_nhwc, flow).permute(0, 3, 1, 2)   # NCHW view, CL
    feat_warp, merged = flow_merge(warped, out, x, scale)
    return feat_warp, merged, out, flow


def _to_flow_rgb(xm, feat_nhwc, p_flow, p_rgb, skip_flow, skip_rgb,
                 warps: Warps = DISPATCH, blur_kernel=(1, 3, 3, 1)):
    """The last level's ToFlow + ToRGB with the warp and the 1×1 conv in
    one kernel, ToFlow's input ``xm`` already modulated.  The merged
    feature is dead at the last level and the 1×1 conv is linear over
    channels, so conv(warp · mask) = mask · conv(warp) (float_tpu
    ``_packed_warp_rgb``).  Returns (rgb, flow)."""
    out, flow = _flow_pred(xm, p_flow, skip_flow, blur_kernel)
    c = feat_nhwc.shape[-1]
    w0 = p_rgb["conv"]["0"]["weight"].float()             # (3, C, 1, 1)
    wk = (w0[:, :, 0, 0] * (1.0 / math.sqrt(c))).contiguous()
    rgb = warps.rgb(feat_nhwc, flow, wk).permute(0, 3, 1, 2) \
        * flow_mask(out, xm.dtype)
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

    mod1, mods = _modulations(params, wa, n_levels)
    const = params["input"]["input"]
    xm = modulate(const.to(dtype).expand(b, -1, -1, -1)
                  .contiguous(memory_format=CL), mod1.scale)
    # xm: the next conv's input, already modulated
    xm = _styled_conv(xm, mod1, params["conv1"], up=False,
                      blur_kernel=blur_kernel, scale=mods[0][0].scale)

    skip = None
    skip_flow = None
    flow64 = None
    for lvl in range(n_levels):
        m_up, m_plain, m_flow = mods[lvl]
        last = lvl == n_levels - 1
        xm = _styled_conv(xm, m_up, params["convs"][str(2 * lvl)], up=True,
                          blur_kernel=blur_kernel, scale=m_plain.scale)
        # the level's map x, which the merge reads, and ToFlow's input; at
        # the last level the merge is dead and x with it
        p_plain = params["convs"][str(2 * lvl + 1)]
        if last:
            x, xm = None, _styled_conv(xm, m_plain, p_plain, up=False,
                                       blur_kernel=blur_kernel,
                                       scale=m_flow.scale)
        else:
            x, xm = _styled_conv(xm, m_plain, p_plain, up=False,
                                 blur_kernel=blur_kernel,
                                 scale2=m_flow.scale)
        feat_l = feats_nhwc[lvl]
        if rgb_in_kernel and last and _is_shared(feat_l, b):
            skip, fl = _to_flow_rgb(
                xm, feat_l, params["to_flows"][str(lvl)],
                params["to_rgbs"][str(lvl)], skip_flow, skip, warps=warps,
                blur_kernel=blur_kernel)
        else:
            nxt = None if last else mods[lvl + 1][0].scale
            out_warp, xm, skip_flow, fl = _to_flow(
                x, xm, feat_l, params["to_flows"][str(lvl)], skip_flow,
                nxt, warps=warps, blur_kernel=blur_kernel)
            skip = _to_rgb(out_warp, params["to_rgbs"][str(lvl)], skip,
                           blur_kernel=blur_kernel)
        if fl.shape[1] == 64:
            flow64 = fl
    return skip, flow64
