"""Image resizing, image files, and image -> model input (twin of
``float_tpu.image.transform``, without OpenCV).

:func:`resize` computes what ``cv2.resize`` computes for the two modes
the pipeline uses, as two separable weight matrices applied with torch on
the host (``out = W_y @ img @ W_xᵀ`` per channel):

- ``INTER_AREA``: when neither axis grows, each output pixel averages the
  input pixels its cell covers, weighted by the covered fraction (cv2's
  ``computeResizeAreaTab``); when an axis grows, both axes take cv2's
  area-upscale weights, linear between ``sx = floor(d·s)`` and ``sx + 1``
  with ``fx = (d + 1) − (sx + 1)/s`` wrapped to [0, 1);
- ``INTER_CUBIC``: cv2's 4-tap cubic (A = −0.75) at source position
  ``(d + 0.5)·s − 0.5``, taps clamped to the edge.

Float images agree with cv2 to float32 rounding; uint8 images are rounded
half to even and clipped, within one level of cv2's fixed-point sums.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# cv2's interpolation flags for the two supported modes
INTER_CUBIC = 2
INTER_AREA = 3


def _area_shrink_weights(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) coverage weights of cv2's area decimation."""
    w = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += np.float32((s1 - f1) / cell)
        for s in range(s1, s2):
            w[d, s] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
    return w


def _area_grow_weights(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_AREA when an axis grows."""
    w = np.zeros((n_out, n_in), np.float32)
    inv = 1.0 / scale
    for d in range(n_out):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(math.floor(f))
        if s < 0:
            s, f = 0, np.float32(0.0)
        if s >= n_in - 1:
            s, f = n_in - 1, np.float32(0.0)
        w[d, s] += np.float32(1.0) - f
        w[d, min(s + 1, n_in - 1)] += f
    return w


def _cubic_weights(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) weights of cv2's INTER_CUBIC, taps clamped."""
    a = np.float32(-0.75)
    w = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        x = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(x)
        x = np.float32(x - s)
        c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + 1
        c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        c3 = np.float32(1.0) - c0 - c1 - c2
        for k, c in zip(range(-1, 3), (c0, c1, c2, c3)):
            w[d, min(max(s + k, 0), n_in - 1)] += c
    return w


def resize(img: np.ndarray, dsize, fx: float = 0.0, fy: float = 0.0,
           interpolation: int = INTER_AREA) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=...)`` for
    ``INTER_AREA`` and ``INTER_CUBIC``: img (H, W) or (H, W, C), float or
    uint8; ``dsize`` = (width, height), or (0, 0) with the scale factors
    ``fx``/``fy`` (the size then rounds, and the factors, not the sizes,
    set the sampling positions, as in cv2)."""
    if interpolation not in (INTER_AREA, INTER_CUBIC):
        raise ValueError(f"unsupported interpolation {interpolation}")
    h_in, w_in = img.shape[:2]
    w_out, h_out = int(dsize[0]), int(dsize[1])
    if w_out > 0 and h_out > 0:
        sx, sy = w_in / w_out, h_in / h_out
    elif fx > 0 and fy > 0:
        w_out, h_out = round(w_in * fx), round(h_in * fy)
        sx, sy = 1.0 / fx, 1.0 / fy
    else:
        raise ValueError("resize needs dsize or both fx and fy")
    if (w_out, h_out) == (w_in, h_in):
        return img.copy()
    if interpolation == INTER_CUBIC:
        wy = _cubic_weights(h_in, h_out, sy)
        wx = _cubic_weights(w_in, w_out, sx)
    elif sx >= 1 and sy >= 1:
        wy = _area_shrink_weights(h_in, h_out, sy)
        wx = _area_shrink_weights(w_in, w_out, sx)
    else:
        wy = _area_grow_weights(h_in, h_out, sy)
        wx = _area_grow_weights(w_in, w_out, sx)
    x = torch.from_numpy(np.asarray(img, dtype=np.float32).reshape(
        h_in, w_in, -1))
    rows = torch.from_numpy(wy) @ x.reshape(h_in, -1)
    out = torch.einsum("ywc,xw->yxc", rows.reshape(h_out, w_in, -1),
                       torch.from_numpy(wx)).numpy()
    out = out.reshape((h_out, w_out) + img.shape[2:])
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype, copy=False)


def load_image_file(path: str) -> np.ndarray:
    """Read an image file into (H, W, 3|4) float32 RGB(A) in [0, 1].

    .npy arrays load directly (scaled from the uint8 range when their
    maximum exceeds 1.5) and need no other package.  Other formats are
    read with OpenCV, imported here; alpha is kept so the RGBA strategies
    apply (reference utils/image.py:38-131)."""
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        return img
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            f"reading {path!r} needs OpenCV (cv2) for its format; save the "
            "image as a .npy array to read it without OpenCV") from exc
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(f"cannot read image {path}")
    if raw.ndim == 2:
        raw = cv2.cvtColor(raw, cv2.COLOR_GRAY2RGB)
    elif raw.shape[-1] == 4:
        raw = cv2.cvtColor(raw, cv2.COLOR_BGRA2RGBA)
    else:
        raw = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
    return raw.astype(np.float32) / 255.0


def to_model_input(img_u8: np.ndarray, input_size: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (1, 3, S, S) float32 in [-1, 1]: INTER_AREA
    resize to S², x / 127.5 - 1, HWC -> CHW (reference CustomTransform,
    src/nodes/generate.py:29-39)."""
    if img_u8.shape[0] != input_size or img_u8.shape[1] != input_size:
        img_u8 = resize(img_u8, (input_size, input_size),
                        interpolation=INTER_AREA)
    x = img_u8.astype(np.float32) / 127.5 - 1.0
    return np.transpose(x, (2, 0, 1))[None]


def comfy_image_to_model_input(image, input_size: int,
                               rgba_conversion: str = "blend_with_color",
                               bkg_color_hex: str = "#000000",
                               face_align=False,   # bool | "fallback"
                               face_margin: float = 1.6,
                               face_index: int = 1,
                               detector=None):
    """Full preprocess: [0, 1] HWC image -> model input (+ bbox if aligned)
    (reference DataProcessor.preprocess, generate.py:75-81).
    Returns (model_input (1, 3, S, S) float32, bbox or None)."""
    from .face_align import face_align_crop
    from .rgba import image_to_uint8

    u8 = image_to_uint8(np.asarray(image), rgba_conversion, bkg_color_hex)
    bbox = None
    if face_align:
        u8, bbox = face_align_crop(
            u8, input_size, margin=face_margin, index=face_index,
            detector=detector,
            allow_fallback=(face_align == "fallback"))
    return to_model_input(u8, input_size), bbox
