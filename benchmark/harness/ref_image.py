"""Plain NumPy reference of the two-face reinsert path's host image work:
the aligned square crop of a detected face, OpenCV's ``INTER_AREA``
resize (shrink: each output pixel the mean of the input area it covers;
grow: cv2's area-upscale weights) and ``INTER_CUBIC``, and the paste of
the faces back into every scene frame, quantised once to uint8 (in
PyTorch on the device).  It imports nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _shrink(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in): the share of output cell d = [d·s, (d+1)·s) that
    input pixel j covers."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    hi = np.minimum(lo + s, n_in)
    j = np.arange(n_in)[None, :]
    cover = np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0.0, None)
    return cover / (hi - lo)


def _grow(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in): cv2's INTER_AREA upscale, linear between
    sx = floor(d·s) and sx + 1 with fx = (d + 1) − (sx + 1)/s, wrapped to
    [0, 1)."""
    s = n_in / n_out
    w = np.zeros((n_out, n_in))
    for d in range(n_out):
        sx = math.floor(d * s)
        fx = (d + 1) - (sx + 1) / s
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if sx >= n_in - 1:
            sx, fx = n_in - 1, 0.0
        w[d, sx] += 1.0 - fx
        w[d, min(sx + 1, n_in - 1)] += fx
    return w


def _cubic(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in): cv2's INTER_CUBIC, Keys' kernel with A = -0.75 at
    the source position (d + 0.5)·s - 0.5, taps clamped to the edge."""
    a, s = -0.75, n_in / n_out
    w = np.zeros((n_out, n_in))
    for d in range(n_out):
        x = (d + 0.5) * s - 0.5
        x0 = math.floor(x)
        for k in range(-1, 3):
            t = abs(x - (x0 + k))
            c = ((a + 2) * t - (a + 3)) * t * t + 1 if t <= 1 else \
                ((a * t - 5 * a) * t + 8 * a) * t - 4 * a
            w[d, min(max(x0 + k, 0), n_in - 1)] += c
    return w


def weights(n_in: int, n_out: int, area: bool, shrink: bool) -> np.ndarray:
    if not area:
        return _cubic(n_in, n_out)
    return (_shrink if shrink else _grow)(n_in, n_out)


def resize(img: np.ndarray, w_out: int, h_out: int, area: bool = True
           ) -> np.ndarray:
    """cv2.resize(img, (w_out, h_out)) of an (H, W, C) image with
    INTER_AREA (``area``) or INTER_CUBIC, computed in float64; uint8 in,
    uint8 out (rounded half to even, clipped)."""
    h_in, w_in = img.shape[:2]
    if (h_in, w_in) == (h_out, w_out):
        return img.copy()
    shrink = w_out <= w_in and h_out <= h_in
    wy = weights(h_in, h_out, area, shrink)
    wx = weights(w_in, w_out, area, shrink)
    c = img.shape[2]
    rows = wy @ img.astype(np.float64).reshape(h_in, w_in * c)
    out = np.matmul(wx, rows.reshape(h_out, w_in, c))      # (h_out, w_out, c)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def face_crop(scene: np.ndarray, box, size: int, margin: float,
              det_height: int = 360):
    """(crop (size, size, 3) uint8, bbox (x, y, w, h)) of one detected box
    (x1, y1, x2, y2) given on the scene's own pixels: the box as the
    detector reports it on the scene resized to ``det_height`` rows, mapped
    back by truncation; a square of side 2·int(max(half_h, half_w)·margin)
    about its centre, zero outside the scene, resized to ``size``."""
    h, w = scene.shape[:2]
    k = det_height / h
    # the aligner resizes with INTER_AREA when it shrinks for detection
    # the detector sees the scene resized to round(h·k) rows
    k_img = round(h * k) / h
    x1, y1, x2, y2 = (int(v * k_img / k) for v in box)
    half_h, half_w = int((y2 - y1) / 2), int((x2 - x1) / 2)
    cy, cx = int((y1 + y2) / 2), int((x1 + x2) / 2)
    half = int(max(half_h, half_w) * margin)
    padded = np.pad(scene, ((half, half), (half, half), (0, 0)))
    crop = padded[cy:cy + 2 * half, cx:cx + 2 * half]
    bbox = (cx - half, cy - half, 2 * half, 2 * half)
    return resize(crop, size, size, area=k < 1), bbox


def composite(scene: np.ndarray, faces, device, block: int = 16
              ) -> torch.Tensor:
    """The scene frames (T, H, W, 3) uint8 on ``device``: every frame the
    scene in [0, 1] with each face's frame ((T, S, S, 3) in [0, 1] on the
    device), resized to its bbox (INTER_AREA where that shrinks it, else
    INTER_CUBIC), pasted over it in list order;
    clipped and rounded half up once.  Computed in float64."""
    bg = torch.from_numpy(scene).to(device, torch.float64) / 255.0
    hh, ww = bg.shape[:2]
    t = faces[0][0].shape[0]
    sized = []
    for frames, (x, y, w, h) in faces:
        s = frames.shape[1]
        area = w < s
        wy = torch.from_numpy(weights(s, h, area, True)).to(device)
        wx = torch.from_numpy(weights(s, w, area, True)).to(device)
        sized.append((frames, wy, wx, (x, y, w, h)))
    out = torch.empty((t, hh, ww, 3), dtype=torch.uint8, device=device)
    for lo in range(0, t, block):
        hi = min(lo + block, t)
        fr = bg.expand(hi - lo, -1, -1, -1).clone()
        for frames, wy, wx, (x, y, w, h) in sized:
            face = torch.einsum("yh,thwc,xw->tyxc", wy,
                                frames[lo:hi].double(), wx)
            x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + w, ww), min(y + h,
                                                                     hh)
            fr[:, y0:y1, x0:x1] = face[:, y0 - y:y1 - y, x0 - x:x1 - x]
        out[lo:hi] = (fr.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return out
