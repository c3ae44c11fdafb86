"""upfirdn2d — upsample / FIR filter / downsample, StyleGAN2's resampling op
(twin of ``float_tpu.ops.upfirdn``).

Semantics: zero-insert ``up - 1`` zeros AFTER each sample, pad by
(pad0, pad1) on both spatial dims (negative pads crop), convolve with the
2-D FIR kernel (correlate with its flip), keep every ``down``-th pixel.
The FIR pass is one depthwise ``F.conv2d``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _blur_kernel(k: tuple, upsample_factor: int, device) -> torch.Tensor:
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
    with torch.inference_mode(False):
        return torch.from_numpy(k).to(device)


def make_blur_kernel(k, upsample_factor: int = 1, device=None) -> torch.Tensor:
    """Normalised outer-product blur kernel, with the ``factor**2`` gain of
    upsampling blurs; made once per taps, factor and device and shared
    (``identity_grid``'s rule: callers must not write to it)."""
    return _blur_kernel(tuple(k), upsample_factor, device)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """upfirdn on an NCHW tensor with a 2-D FIR kernel."""
    pad0, pad1 = pad
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(pad0, 0), max(pad1, 0), max(pad0, 0), max(pad1, 0)])
    lo, hi = max(-pad0, 0), max(-pad1, 0)
    x = x[:, :, lo:x.shape[2] - hi, lo:x.shape[3] - hi]
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    k = k[None, None].expand(c, 1, kh, kw)
    return F.conv2d(x, k, stride=down, groups=c)


def blur(x: torch.Tensor, kernel: torch.Tensor,
         pad: tuple[int, int]) -> torch.Tensor:
    """FIR blur, no resampling (reference Blur module, encoder.py:60-74)."""
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)


def upsample2x(x: torch.Tensor, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """2x upsample with FIR smoothing (reference Upsample)."""
    factor = 2
    kernel = make_blur_kernel(blur_kernel, factor, device=x.device)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2x(x: torch.Tensor, blur_kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """2x downsample with FIR anti-aliasing (reference Downsample)."""
    factor = 2
    kernel = make_blur_kernel(blur_kernel, device=x.device)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor,
                     pad=((p + 1) // 2, p // 2))
