"""Face-aligned square cropping (reference: src/nodes/utils/image.py:134-180;
twin of ``float_tpu.image.face_align``, with the port's own resize and
border in place of OpenCV's).

Crop geometry parity:
- the image is resized so height -> 360 px for detection,
- detections with score <= 0.95 are dropped; boxes are mapped back to the
  original resolution; the ``index``-th face is selected (1-based, falls
  back to the first with a warning),
- crop side = 2 * max(half_h, half_w) * margin, centered on the bbox
  center, constant-0 border padding, then resize to ``input_size``,
- no face -> centered square crop of side 2*min(cx, cy) with a warning.

Returns (crop, bbox=(x, y, w, h)) where bbox locates the crop in the
original image for later reinsertion (image/composite.py).

The SFD detector itself is pluggable: pass any ``detector(img_rgb_uint8)
-> [(x1, y1, x2, y2, score), ...]``.  The default detector requires the
``face_alignment`` package like the reference does (a missing package
raises rather than silently changing the output); the degraded
center-crop path is explicit opt-in via ``allow_fallback=True``.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .transform import INTER_AREA, INTER_CUBIC, resize

logger = logging.getLogger("float_torch.face_align")

_fa_detector = None


def _default_detector(img: np.ndarray):
    """SFD via the face_alignment package (lazy singleton).

    Raises ImportError when the package is absent: the reference
    hard-imports it (src/nodes/utils/image.py:9), so a silent center-crop
    here would make outputs differ from the reference on the same inputs.
    Callers that explicitly want the degraded path pass
    ``allow_fallback=True`` (or their own detector).
    """
    global _fa_detector
    if _fa_detector is None:
        import face_alignment
        _fa_detector = face_alignment.FaceAlignment(
            face_alignment.LandmarksType.TWO_D, flip_input=False)
    return _fa_detector.face_detector.detect_from_image(img)


def detect_faces(img: np.ndarray,
                 detector: Optional[Callable] = None,
                 allow_fallback: bool = False) -> Optional[list]:
    det = detector or _default_detector
    try:
        return det(img)
    except ImportError:
        if detector is not None:
            # a custom detector's own import failure is a real error, not
            # "face_alignment is missing" — surface it unchanged
            raise
        if allow_fallback:
            logger.warning("face_alignment not installed; using the "
                           "no-face center-crop path")
            return None
        raise ImportError(
            "face alignment requested but the 'face_alignment' package is "
            "not installed (the reference hard-requires it).  Install it, "
            "pass a custom detector, or opt into the center-crop fallback "
            "with allow_fallback=True / face_align='fallback'.")
    except Exception as exc:          # runtime detector failure -> fallback
        logger.warning("face detection failed (%s); using center crop", exc)
        return None


def face_align_crop(
    img: np.ndarray,                  # (H, W, 3) uint8 RGB
    input_size: int,
    margin: float = 1.6,
    index: int = 1,
    detector: Optional[Callable] = None,
    allow_fallback: bool = False,
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Detect + crop; returns (crop (S, S, 3) uint8, bbox (x, y, w, h)).

    A missing face_alignment package raises unless ``allow_fallback``
    (see detect_faces); no-face / detector-runtime failures center-crop
    like the reference."""
    det_scale = 360.0 / img.shape[0]
    interp = INTER_AREA if det_scale < 1.0 else INTER_CUBIC
    resized = resize(img, dsize=(0, 0), fx=det_scale, fy=det_scale,
                     interpolation=interp)

    raw = detect_faces(resized, detector, allow_fallback=allow_fallback)
    bboxes: Sequence = []
    if raw:
        bboxes = [(int(x1 / det_scale), int(y1 / det_scale),
                   int(x2 / det_scale), int(y2 / det_scale), s)
                  for (x1, y1, x2, y2, s) in raw if s > 0.95]

    if not bboxes:
        logger.warning("no face detected; using center square crop")
        cy = img.shape[0] // 2
        cx = img.shape[1] // 2
        half_side = min(cx, cy)
        bbox = (cx - half_side, cy - half_side, 2 * half_side, 2 * half_side)
    else:
        if index > len(bboxes):
            logger.warning("only %d faces detected, using the first", len(bboxes))
            index = 1
        x1, y1, x2, y2, _score = bboxes[index - 1]
        # int(x/2), NOT x//2: the reference truncates toward zero
        # (utils/image.py:167-170) and detector boxes at image edges can
        # have negative coords where floor and trunc differ by one pixel
        half_h = int((y2 - y1) / 2)
        half_w = int((x2 - x1) / 2)
        cy = int((y1 + y2) / 2)
        cx = int((x1 + x2) / 2)
        half_side = int(max(half_h, half_w) * margin)
        img = np.pad(img, ((half_side, half_side), (half_side, half_side),
                           (0, 0)))      # cv2.copyMakeBorder, constant 0
        bbox = (cx - half_side, cy - half_side, 2 * half_side, 2 * half_side)
        cy, cx = cy + half_side, cx + half_side

    crop = img[cy - half_side:cy + half_side, cx - half_side:cx + half_side]
    crop = resize(crop, dsize=(input_size, input_size), interpolation=interp)
    return crop, bbox
