"""RGBA -> RGB conversion strategies + image tensor normalization (twin of
``float_tpu.image.rgba``, numpy only).

Behavioral parity with the reference (src/nodes/utils/image.py:25-131):
three strategies over uint8 HWC arrays, hex background colors with
warn-and-default-to-black on bad input.
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("float_torch.image")


def hex_to_rgb_uint8(hex_color: str) -> tuple[int, int, int]:
    """'#RRGGBB' -> (R, G, B) uint8 tuple; invalid input -> black + warning."""
    h = hex_color.lstrip("#")
    if len(h) != 6:
        logger.warning("invalid hex color %r, defaulting to black", hex_color)
        return (0, 0, 0)
    try:
        return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))
    except ValueError:
        logger.warning("invalid hex color %r, defaulting to black", hex_color)
        return (0, 0, 0)


def rgba_to_rgb(image: np.ndarray, strategy: str, bkg_color_hex: str) -> np.ndarray:
    """(H, W, 4) uint8 -> (H, W, 3) uint8.

    - discard_alpha: drop the alpha channel,
    - blend_with_color: alpha-blend over the background color,
    - replace_with_color: replace only fully-transparent (alpha==0) pixels.
    """
    bg = hex_to_rgb_uint8(bkg_color_hex)
    rgb = image[..., :3]
    alpha = image[..., 3]

    if strategy == "discard_alpha":
        return rgb
    if strategy == "blend_with_color":
        a = (alpha.astype(np.float32) / 255.0)[..., None]
        bg_img = np.full_like(rgb, np.array(bg, dtype=np.uint8))
        out = rgb.astype(np.float32) * a + bg_img.astype(np.float32) * (1.0 - a)
        return np.clip(out, 0, 255).astype(np.uint8)
    if strategy == "replace_with_color":
        out = rgb.copy()
        out[alpha == 0] = bg
        return out
    logger.warning("unknown RGBA strategy %r, using discard_alpha", strategy)
    return rgb


def image_to_uint8(image: np.ndarray, rgba_conversion: str = "blend_with_color",
                   bkg_color_hex: str = "#000000") -> np.ndarray:
    """float [0,1] (B,H,W,C)|(H,W,C) RGB(A) -> (H, W, 3) uint8.

    Batch inputs use the first item (parity: utils/image.py:86-131).
    """
    if image.ndim == 4:
        if image.shape[0] != 1:
            logger.warning("batch of %d images, processing only the first",
                           image.shape[0])
        image = image[0]
    if image.ndim != 3:
        raise ValueError(f"expected (H,W,C) or (B,H,W,C), got {image.shape}")
    u8 = np.clip(np.asarray(image, dtype=np.float32) * 255.0, 0, 255).astype(np.uint8)
    if u8.shape[2] == 4:
        return rgba_to_rgb(u8, rgba_conversion, bkg_color_hex)
    return u8
