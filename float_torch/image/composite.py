"""Face reinsertion compositing — paste generated frames back at the bbox
(twin of ``float_tpu.image.composite``, with the port's own resize in place
of OpenCV's).

The reference delegates this to external SET_CompositeFace /
SET_CompositeFaceFrameByFrame nodes (SURVEY §3.5); the framework provides
the equivalent primitive so the "insert" workflows (incl. two-face) are
expressible end-to-end.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .transform import INTER_AREA, INTER_CUBIC, resize


def composite_face(
    background: np.ndarray,          # (H, W, 3) float [0,1] or uint8
    face: np.ndarray,                # (S, S, 3) float [0,1]
    bbox: Tuple[int, int, int, int],  # (x, y, w, h) from face_align_crop
    feather: int = 0,                # optional edge feathering radius (px)
) -> np.ndarray:
    """Paste one face frame into the background at bbox; returns float [0,1].

    The bbox may extend beyond the background (the aligner pads with a
    constant border); out-of-bounds regions are clipped.
    """
    bg = background.astype(np.float32)
    if bg.max() > 1.5:
        bg = bg / 255.0
    x, y, w, h = bbox
    face_r = resize(face.astype(np.float32), (w, h),
                    interpolation=INTER_AREA if w < face.shape[1]
                    else INTER_CUBIC)

    hh, ww = bg.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, ww), min(y + h, hh)
    if x0 >= x1 or y0 >= y1:
        return bg
    fx0, fy0 = x0 - x, y0 - y
    fx1, fy1 = fx0 + (x1 - x0), fy0 + (y1 - y0)

    patch = face_r[fy0:fy1, fx0:fx1]
    if feather > 0:
        mask = np.ones(patch.shape[:2], np.float32)
        f = min(feather, min(mask.shape) // 2)
        ramp = np.linspace(0.0, 1.0, f, endpoint=False)
        mask[:f, :] *= ramp[:, None]
        mask[-f:, :] *= ramp[::-1][:, None]
        mask[:, :f] *= ramp[None, :]
        mask[:, -f:] *= ramp[::-1][None, :]
        mask = mask[..., None]
        out_patch = bg[y0:y1, x0:x1] * (1 - mask) + patch * mask
    else:
        out_patch = patch
    out = bg.copy()
    out[y0:y1, x0:x1] = out_patch
    return out


def composite_face_frames(
    background: np.ndarray,          # (H, W, 3) or (T, H, W, 3)
    frames: np.ndarray,              # (T, S, S, 3) float [0,1]
    bbox: Tuple[int, int, int, int],
    feather: int = 0,
    inplace: bool = False,
) -> np.ndarray:
    """Frame-by-frame variant: static background or per-frame backgrounds.

    Equivalent of SET_CompositeFaceFrameByFrame; returns (T, H, W, 3).

    Same output as looping ``composite_face`` (tested), but the
    background normalization / copies / feather mask are hoisted out of
    the per-frame loop: the naive loop re-scanned and re-copied the full
    background 3x per frame, which dominated the two-face insert config
    (~40 ms/frame of pure numpy at 768x1024 — PERF.md config 5).

    ``inplace=True`` with a per-frame float32 background patches it
    directly and returns it (no (T, H, W, 3) copy — the full-stack copy
    is host-memory-bandwidth bound and costs more than all the resizes;
    the multi-face insert loop uses this for faces 2..n)."""
    t = frames.shape[0]
    per_frame_bg = background.ndim == 4
    if per_frame_bg and background.shape[0] != t:
        raise ValueError(
            f"background frames {background.shape[0]} != face frames {t}")
    bg_f = background.astype(np.float32, copy=False)
    if per_frame_bg:
        # the [0,255]-scale decision is PER FRAME, matching the
        # documented-equivalent composite_face loop: a mixed-scale stack
        # (e.g. one near-black frame among uint8-range frames) must
        # normalize each frame by its own range (ADVICE r4)
        fmax = bg_f.reshape(t, -1).max(axis=1)
        if (fmax > 1.5).any():
            bg_f = bg_f / np.where(fmax > 1.5, 255.0,
                                   1.0)[:, None, None, None]
    elif bg_f.max() > 1.5:
        bg_f = bg_f / 255.0

    x, y, w, h = bbox
    hh, ww = bg_f.shape[-3], bg_f.shape[-2]
    if (inplace and per_frame_bg and bg_f is background
            and background.dtype == np.float32):
        out = background
    else:
        out = np.empty((t, hh, ww, 3), np.float32)
        if per_frame_bg:
            np.copyto(out, bg_f)
        else:
            out[:] = bg_f[None]

    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, ww), min(y + h, hh)
    if x0 >= x1 or y0 >= y1:
        return out
    fx0, fy0 = x0 - x, y0 - y
    fx1, fy1 = fx0 + (x1 - x0), fy0 + (y1 - y0)

    mask = None
    if feather > 0:
        mask = np.ones((y1 - y0, x1 - x0), np.float32)
        f = min(feather, min(mask.shape) // 2)
        ramp = np.linspace(0.0, 1.0, f, endpoint=False)
        mask[:f, :] *= ramp[:, None]
        mask[-f:, :] *= ramp[::-1][:, None]
        mask[:, :f] *= ramp[None, :]
        mask[:, -f:] *= ramp[::-1][None, :]
        mask = mask[..., None]

    interp = (INTER_AREA if w < frames.shape[2] else INTER_CUBIC)
    for i in range(t):
        face_r = resize(frames[i].astype(np.float32, copy=False),
                        (w, h), interpolation=interp)
        patch = face_r[fy0:fy1, fx0:fx1]
        if mask is not None:
            out[i, y0:y1, x0:x1] = (out[i, y0:y1, x0:x1] * (1 - mask)
                                    + patch * mask)
        else:
            out[i, y0:y1, x0:x1] = patch
    return out


def _face_geometry(bbox, hh: int, ww: int, face_size: int, feather: int):
    """Clipped paste geometry + optional feather mask for one face."""
    x, y, w, h = bbox
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, ww), min(y + h, hh)
    if x0 >= x1 or y0 >= y1:
        return None
    fx0, fy0 = x0 - x, y0 - y
    mask = None
    if feather > 0:
        mask = np.ones((y1 - y0, x1 - x0), np.float32)
        f = min(feather, min(mask.shape) // 2)
        ramp = np.linspace(0.0, 1.0, f, endpoint=False)
        mask[:f, :] *= ramp[:, None]
        mask[-f:, :] *= ramp[::-1][:, None]
        mask[:, :f] *= ramp[None, :]
        mask[:, -f:] *= ramp[::-1][None, :]
        mask = mask[..., None]
    interp = INTER_AREA if w < face_size else INTER_CUBIC
    return (w, h), (x0, y0, x1, y1), (fx0, fy0), mask, interp


def composite_faces_stream(
    background: np.ndarray,          # (H, W, 3) or (T, H, W, 3)
    faces,                           # [(frames (T,S,S,3) [0,1], bbox), ...]
    feather: int = 0,
):
    """Multi-face compositing as a GENERATOR of per-frame uint8 images.

    Yields (H, W, 3) uint8 frames, all faces pasted in one pass per
    frame, and never materializes the (T, H, W, 3) float32 output stack
    (~2.4 GB + a full-stack copy for a 10 s clip at 768x1024 — the
    dominant host cost of the two-face insert config after round 4,
    VERDICT r4 weak #8).  Feed directly to io.video.write_video (it
    accepts frame iterators) or any per-frame sink.

    Output is IDENTICAL (tested) to running ``composite_face_frames``
    once per face (in list order, later faces over earlier ones) and
    then uint8-quantizing, because each frame composites in float32 and
    quantizes once at the end — the same arithmetic, reordered per
    frame."""
    faces = [(np.asarray(fr), bbox) for fr, bbox in faces]
    if not faces:
        raise ValueError("faces must be non-empty")
    t = faces[0][0].shape[0]
    for fr, _ in faces:
        if fr.shape[0] != t:
            raise ValueError(f"face frame counts differ: {fr.shape[0]} != {t}")
    per_frame_bg = background.ndim == 4
    if per_frame_bg and background.shape[0] != t:
        raise ValueError(
            f"background frames {background.shape[0]} != face frames {t}")
    hh, ww = background.shape[-3], background.shape[-2]

    geo = [_face_geometry(bbox, hh, ww, fr.shape[2], feather)
           for fr, bbox in faces]

    bg_static = None
    if not per_frame_bg:
        bg_static = background.astype(np.float32, copy=False)
        if bg_static.max() > 1.5:
            bg_static = bg_static / 255.0

    for i in range(t):
        if per_frame_bg:
            bg_i = background[i].astype(np.float32)
            if bg_i.max() > 1.5:        # per-frame scale decision
                bg_i /= 255.0
        else:
            bg_i = bg_static.copy()
        for (fr, _bbox), g in zip(faces, geo):
            if g is None:
                continue
            (w, h), (x0, y0, x1, y1), (fx0, fy0), mask, interp = g
            face_r = resize(fr[i].astype(np.float32, copy=False),
                            (w, h), interpolation=interp)
            patch = face_r[fy0:fy0 + (y1 - y0), fx0:fx0 + (x1 - x0)]
            if mask is not None:
                bg_i[y0:y1, x0:x1] = (bg_i[y0:y1, x0:x1] * (1 - mask)
                                      + patch * mask)
            else:
                bg_i[y0:y1, x0:x1] = patch
        yield (np.clip(bg_i, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
