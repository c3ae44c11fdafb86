"""YUV 4:2:0 wire codec (twin of ``float_tpu.ops.yuv420``): halves the
device-to-host bytes of a frame for delivery paths whose final encoding
subsamples chroma anyway (JPEG streams, every 4:2:0 video codec).

Matrix: BT.601 full range (JFIF), the one JPEG uses.  Packed layout per
frame (H and W even): ``(H*3//2, W)`` uint8 — the Y plane (H, W) on top,
then Cb (H//2, W//2) and Cr (H//2, W//2) side by side in the bottom
(H//2, W) block.  ``rgb01_to_i420`` runs in torch on the frames' device;
its inverse ``i420_to_rgb_u8`` runs in numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

# JFIF / BT.601 full-range forward constants
_KR, _KG, _KB = 0.299, 0.587, 0.114
_CB_SCALE = 0.5 / (1.0 - _KB)     # 0.564334...
_CR_SCALE = 0.5 / (1.0 - _KR)     # 0.713267...


def rgb01_to_i420(img: torch.Tensor) -> torch.Tensor:
    """(fb, H, W, 3) float32 RGB in [0, 1] -> (fb, H*3//2, W) uint8 planar
    4:2:0.  Chroma is 2×2 box-averaged BEFORE quantisation; quantisation
    rounds half to even."""
    r, g, b = img.unbind(-1)
    y = _KR * r + _KG * g + _KB * b
    cb = 0.5 + (b - y) * _CB_SCALE
    cr = 0.5 + (r - y) * _CR_SCALE
    fb, h, w = y.shape
    cb = cb.reshape(fb, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    cr = cr.reshape(fb, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def q(x):
        return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    chroma = torch.cat([q(cb), q(cr)], dim=2)            # (fb, H//2, W)
    return torch.cat([q(y), chroma], dim=1)


def i420_to_rgb_u8(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse: (T, H*3//2, W) uint8 -> (T, H, W, 3) uint8 RGB.
    Chroma upsamples by pixel replication (the JPEG-decoder convention);
    the inverse of ``rgb01_to_i420`` up to quantisation and subsampling."""
    packed = np.asarray(packed)
    squeeze = packed.ndim == 2
    if squeeze:
        packed = packed[None]
    t, h15, w = packed.shape
    h = (h15 * 2) // 3
    y = packed[:, :h].astype(np.float32)
    cb = packed[:, h:, : w // 2].astype(np.float32) - 127.5
    cr = packed[:, h:, w // 2:].astype(np.float32) - 127.5
    cb = cb.repeat(2, axis=1).repeat(2, axis=2)
    cr = cr.repeat(2, axis=1).repeat(2, axis=2)
    out = np.empty((t, h, w, 3), np.float32)
    out[..., 0] = y + (1.0 / _CR_SCALE) * cr
    out[..., 1] = y - (_KB / _KG / _CB_SCALE) * cb \
        - (_KR / _KG / _CR_SCALE) * cr
    out[..., 2] = y + (1.0 / _CB_SCALE) * cb
    np.clip(out, 0.0, 255.0, out=out)
    out = (out + 0.5).astype(np.uint8)
    return out[0] if squeeze else out
