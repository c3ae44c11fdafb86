"""Bilinear flow warping of a shared feature map (twin of the decode's use
of ``float_tpu.ops.warp`` / ``ops.nhwc.warp_cl``).

Semantics: ``F.grid_sample`` with bilinear taps, ``padding_mode='zeros'``
and ``align_corners=False`` (reference styledecoder.py:423), applied to
ONE feature map shared by every frame of a decode chunk.

``warp_shared`` dispatches on where the tensors lie: CPU tensors take the
plain PyTorch version ``warp_shared_ref``; CUDA tensors take the
hand-written kernel (``float_torch.kernels.warp_shared``), which raises
on inputs it does not take.  Neither returns the TPU kernels' overflow
flags: both are exact for any displacement.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _identity_grid_np(size: int) -> np.ndarray:
    xs = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx, gy], axis=-1)


def identity_grid(size: int, device=None) -> torch.Tensor:
    """(H, W, 2) f32 identity sampling grid, xy order.

    Keeps the reference's ``np.linspace(-1, 1, size)`` (styledecoder.py:
    404-406), which is NOT the pixel-centre grid of align_corners=False:
    the identity flow itself shifts the image by up to half a pixel."""
    return torch.from_numpy(_identity_grid_np(size)).to(device)


def warp_shared_ref(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain version: feat (1, H, W, C), grid (B, H, W, 2) xy in [-1, 1]
    -> (B, H, W, C) in feat's dtype, accumulated in f32.

    Taps outside the image contribute 0; coordinates follow
    align_corners=False: ((g + 1) * size - 1) / 2."""
    _, h, w, c = feat.shape
    f = feat[0].float().reshape(h * w, c)
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    fx = ((gx + 1.0) * w - 1.0) * 0.5
    fy = ((gy + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    out = None
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yy = y0 + dy
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xx = x0 + dx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = torch.where(valid, yy * w + xx, 0.0).long()
            wgt = torch.where(valid, wy * wx, 0.0)
            term = f[idx] * wgt[..., None]
            out = term if out is None else out + term
    return out.to(feat.dtype)


def warp_shared(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp the shared NHWC map ``feat`` (1, H, W, C) by ``grid``
    (B, H, W, 2): the plain version on CPU tensors, the CUDA kernel
    otherwise."""
    if feat.device.type == "cpu" and grid.device.type == "cpu":
        return warp_shared_ref(feat, grid)
    from ..kernels.warp_shared import warp_shared_cuda
    return warp_shared_cuda(feat, grid)
