"""Bilinear flow warping of the decode's feature maps (twin of the
decode's use of ``float_tpu.ops.warp`` / ``ops.nhwc.warp_cl``).

Semantics: ``F.grid_sample`` with bilinear taps, ``padding_mode='zeros'``
and ``align_corners=False`` (reference styledecoder.py:423).  Three forms,
each a plain PyTorch version beside a dispatcher:

- ``warp_shared``    ONE feature map (1, H, W, C) shared by the B frames of
                     a decode chunk (K1, ``kernels/csrc/warp_shared.cu``);
- ``warp_per_frame`` B feature maps (B, H, W, C), one per frame (K3, the
                     per-frame entry of the same CUDA source);
- ``warp_rgb``       the shared warp contracted with the last level's 1×1
                     ToRGB weight (3, C) before any rounding (K2,
                     ``kernels/csrc/warp_rgb.cu``).

``grid_sample_bilinear`` is the public NCHW op of ``float_tpu.ops`` at any
output size; it reaches K3 where K3 takes the shape.

Each dispatcher takes the plain version for CPU tensors and the
hand-written kernel for CUDA tensors; a kernel raises on inputs it does
not take.  None returns the TPU kernels' overflow flags: all are exact for
any displacement.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

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


def _warp_f32(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat (1 or B, H, W, C), grid (B, Ho, Wo, 2) -> (B, Ho, Wo, C) f32 sums
    of the four taps, each product and sum rounded in f32 in this order
    (the CUDA kernels round the same way)."""
    bf, h, w, c = feat.shape
    b = grid.shape[0]
    f = feat.float().reshape(bf * h * w, c)
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    fx = ((gx + 1.0) * w - 1.0) * 0.5
    fy = ((gy + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    base = None
    if bf > 1:
        base = (torch.arange(b, device=grid.device) * (h * w))[:, None, None]
    out = None
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yy = y0 + dy
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xx = x0 + dx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = torch.where(valid, yy * w + xx, 0.0).long()
            if base is not None:
                idx = idx + base
            wgt = torch.where(valid, wy * wx, 0.0)
            term = f[idx] * wgt[..., None]
            out = term if out is None else out + term
    return out


def _check_grid(feat: torch.Tensor, grid: torch.Tensor, batch: int) -> None:
    if feat.ndim != 4 or feat.shape[0] != batch:
        raise ValueError(f"feat must be ({batch}, H, W, C), got "
                         f"{tuple(feat.shape)}")
    if grid.ndim != 4 or tuple(grid.shape[1:]) != (*feat.shape[1:3], 2):
        raise ValueError(f"grid must be (B, H, W, 2) with feat's H, W, got "
                         f"{tuple(grid.shape)}")


def warp_shared_ref(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: feat (1, H, W, C), grid (B, H, W, 2) xy in
    [-1, 1] -> (B, H, W, C) in feat's dtype, accumulated in f32.

    Taps outside the image contribute 0; coordinates follow
    align_corners=False: ((g + 1) * size - 1) / 2."""
    _check_grid(feat, grid, 1)
    return _warp_f32(feat, grid).to(feat.dtype)


def warp_per_frame_ref(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: frame b's map feat[b] (B, H, W, C) warped by
    grid[b] (B, H, W, 2) -> (B, H, W, C) in feat's dtype."""
    _check_grid(feat, grid, grid.shape[0])
    return _warp_f32(feat, grid).to(feat.dtype)


def warp_rgb_ref(feat: torch.Tensor, grid: torch.Tensor,
                 wk: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the f32 warp sums of the shared map feat
    (1, H, W, C) by grid (B, H, W, 2), contracted with wk (3, C) f32, then
    cast to feat's dtype -> (B, H, W, 3).  The order of
    ``shift_warp_v2._kernel``'s ToRGB epilogue: no rounding between the
    warp and the contraction."""
    _check_grid(feat, grid, 1)
    if tuple(wk.shape) != (3, feat.shape[-1]):
        raise ValueError(f"wk must be (3, {feat.shape[-1]}), got "
                         f"{tuple(wk.shape)}")
    return (_warp_f32(feat, grid) @ wk.float().t()).to(feat.dtype)


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def warp_shared(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp the shared NHWC map ``feat`` (1, H, W, C) by ``grid``
    (B, H, W, 2): the plain version on CPU tensors, the CUDA kernel
    otherwise."""
    if _on_cpu(feat, grid):
        return warp_shared_ref(feat, grid)
    from ..kernels.warp_shared import warp_shared_cuda
    return warp_shared_cuda(feat, grid)


def warp_per_frame(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp each frame's NHWC map ``feat`` (B, H, W, C) by its ``grid``
    (B, H, W, 2): the plain version on CPU tensors, the CUDA kernel
    otherwise."""
    if _on_cpu(feat, grid):
        return warp_per_frame_ref(feat, grid)
    from ..kernels.warp_shared import warp_per_frame_cuda
    return warp_per_frame_cuda(feat, grid)


def warp_rgb(feat: torch.Tensor, grid: torch.Tensor,
             wk: torch.Tensor) -> torch.Tensor:
    """Warp the shared map ``feat`` (1, H, W, C) by ``grid`` (B, H, W, 2)
    and contract the channels with ``wk`` (3, C) -> (B, H, W, 3): the
    plain version on CPU tensors, the CUDA kernel otherwise."""
    if _on_cpu(feat, grid, wk):
        return warp_rgb_ref(feat, grid, wk)
    from ..kernels.warp_rgb import warp_rgb_cuda
    return warp_rgb_cuda(feat, grid, wk)


def _check_sample(feat: torch.Tensor, grid: torch.Tensor) -> None:
    if feat.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2 \
            or grid.shape[0] != feat.shape[0]:
        raise ValueError(f"feat must be (B, C, H, W) and grid (B, Ho, Wo, "
                         f"2), got {tuple(feat.shape)} and "
                         f"{tuple(grid.shape)}")


def grid_sample_bilinear_ref(feat: torch.Tensor,
                             grid: torch.Tensor) -> torch.Tensor:
    """Plain version of ``grid_sample_bilinear``: feat (B, C, H, W) sampled
    at grid (B, Ho, Wo, 2) -> (B, C, Ho, Wo) in feat's dtype, the four taps
    summed in f32 as ``warp_per_frame_ref`` sums them."""
    _check_sample(feat, grid)
    out = _warp_f32(feat.permute(0, 2, 3, 1), grid)
    return out.to(feat.dtype).permute(0, 3, 1, 2)


def _k3_supports(feat: torch.Tensor, grid: torch.Tensor) -> bool:
    """K3 takes a bf16 or f32 map of any C sampled at its own resolution
    (Ho, Wo == H, W): every shape the TPU kernel's ``supports`` takes."""
    _b, _c, h, w = feat.shape
    return (feat.dtype in (torch.bfloat16, torch.float32)
            and tuple(grid.shape[1:3]) == (h, w))


def grid_sample_bilinear(feat: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (B, C, H, W) at ``grid`` (B, Ho, Wo, 2), normalised
    xy in [-1, 1] -> (B, C, Ho, Wo): ``F.grid_sample`` with bilinear taps,
    ``padding_mode='zeros'``, ``align_corners=False`` (twin of
    ``float_tpu.ops.grid_sample_bilinear``).

    The reference's dispatch rule: its Pallas kernel where ``supports``
    holds (a bf16 map sampled at its own resolution), the plain gather
    otherwise.  Here a bf16 or f32 CUDA map of any C sampled at its own
    resolution goes through K3 (``warp_per_frame``); another output size
    or dtype, where the reference runs no kernel either, and every CPU
    tensor, runs ``grid_sample_bilinear_ref``."""
    _check_sample(feat, grid)
    if _on_cpu(feat, grid) or not _k3_supports(feat, grid):
        return grid_sample_bilinear_ref(feat, grid)
    nhwc = feat.permute(0, 2, 3, 1).contiguous()
    return warp_per_frame(nhwc, grid.float().contiguous()).permute(0, 3, 1, 2)


class Warps(NamedTuple):
    """The three warp forms the synthesis decode calls."""
    shared: Callable
    per_frame: Callable
    rgb: Callable


# The dispatchers (kernels on CUDA tensors), and the plain versions, which
# a caller passes to hold a decode through the kernels against one through
# plain PyTorch on the same device.
DISPATCH = Warps(warp_shared, warp_per_frame, warp_rgb)
PLAIN = Warps(warp_shared_ref, warp_per_frame_ref, warp_rgb_ref)
