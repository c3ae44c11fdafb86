"""Video output: frame writing + audio muxing (twin of
``float_tpu.io.video``).

The reference delegates muxing to external VHS nodes (SURVEY §3.3); a
standalone talking-head tool must ship sound itself.  ``write_video``
accepts either a full (T, H, W, 3) array or an iterator of frame chunks
(the streaming path: chunks are written as they arrive, so the file grows
while the device still decodes).

Frames are written with OpenCV's ``VideoWriter`` when ``cv2`` imports, or
else piped as raw RGB to an ``ffmpeg`` binary on PATH; with neither,
``write_video`` raises.  Muxing: if ``ffmpeg`` is on PATH the silent video
and a temporary wav are muxed into the target container; otherwise the
video stays silent and the audio goes to a ``<output>.wav`` sidecar with a
warning.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
import wave as wavmod
from typing import Iterable, Optional, Union

import numpy as np

logger = logging.getLogger("float_torch.video")


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000):
    """Write mono/stereo float32 [-1,1] (C, N) or (N,) audio as 16-bit wav."""
    arr = np.asarray(audio, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    pcm = np.clip(arr, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wavmod.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.T.tobytes())


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def mux_audio(video_path: str, wav_path: str, out_path: str) -> bool:
    """ffmpeg-copy the video stream + encode the wav as AAC into out_path.
    Returns False (and logs) when ffmpeg is missing or fails."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    try:
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", video_path,
             "-i", wav_path, "-c:v", "copy", "-c:a", "aac", "-shortest",
             out_path],
            check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, OSError) as exc:
        logger.warning("ffmpeg mux failed (%s); keeping silent video", exc)
        return False


FrameSource = Union[np.ndarray, Iterable]


class _FfmpegWriter:
    """Raw RGB frames piped to ``ffmpeg`` (mpeg4, yuv420p)."""

    def __init__(self, path: str, fps: float, w: int, h: int):
        self.proc = subprocess.Popen(
            [shutil.which("ffmpeg"), "-y", "-loglevel", "error",
             "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
             "-r", str(fps), "-i", "-", "-an", "-c:v", "mpeg4",
             "-q:v", "3", "-pix_fmt", "yuv420p", path],
            stdin=subprocess.PIPE, stderr=subprocess.PIPE)

    def write(self, rgb: np.ndarray) -> None:
        self.proc.stdin.write(np.ascontiguousarray(rgb).tobytes())

    def release(self) -> None:
        self.proc.stdin.close()
        err = self.proc.stderr.read()
        if self.proc.wait() != 0:
            raise IOError(f"ffmpeg failed: {err.decode(errors='replace')}")


class _Cv2Writer:
    def __init__(self, cv2, path: str, fps: float, w: int, h: int):
        self.cv2 = cv2
        self.vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                  fps, (w, h))
        if not self.vw.isOpened():
            raise IOError(f"cannot open video writer for {path}")

    def write(self, rgb: np.ndarray) -> None:
        self.vw.write(self.cv2.cvtColor(rgb, self.cv2.COLOR_RGB2BGR))

    def release(self) -> None:
        self.vw.release()


def video_backend() -> str:
    """What ``write_video`` writes frames through: "cv2" when OpenCV
    imports, else "ffmpeg" when the binary is on PATH, else "" (it
    raises)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return "ffmpeg" if have_ffmpeg() else ""
    return "cv2"


def _open_writer(path: str, fps: float, w: int, h: int):
    backend = video_backend()
    if backend == "cv2":
        import cv2
        return _Cv2Writer(cv2, path, fps, w, h)
    if backend == "ffmpeg":
        return _FfmpegWriter(path, fps, w, h)
    raise RuntimeError(
        f"cannot write {path}: neither OpenCV (cv2) nor an ffmpeg "
        "binary on PATH is available")


def write_video(path: str, frames: FrameSource, fps: float,
                audio: Optional[np.ndarray] = None,
                sample_rate: int = 16000) -> str:
    """Write frames (array (T, H, W, 3) float32 [0,1] / uint8, or an
    iterator of such chunks) to ``path``; mux ``audio`` in when possible.

    Returns the path actually holding the audio ('' if silent): the
    muxed video itself, or the sidecar wav when ffmpeg is unavailable.
    """
    if isinstance(frames, np.ndarray):
        frames = [frames]

    vw = None
    n = 0
    for chunk in frames:
        arr = np.asarray(chunk)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if vw is None:
            h, w = arr.shape[1:3]
            vw = _open_writer(path, fps, w, h)
        for f in arr:
            vw.write(f)
            n += 1
    if vw is None:
        raise ValueError("no frames to write")
    vw.release()
    logger.info("wrote %d frames to %s", n, path)

    if audio is None:
        return ""
    with tempfile.TemporaryDirectory() as td:
        wav_tmp = os.path.join(td, "audio.wav")
        write_wav(wav_tmp, audio, sample_rate)
        muxed = os.path.join(td, "muxed" + os.path.splitext(path)[1])
        if mux_audio(path, wav_tmp, muxed):
            shutil.move(muxed, path)
            return path
        sidecar = os.path.splitext(path)[0] + ".wav"
        shutil.copy(wav_tmp, sidecar)
        logger.warning("ffmpeg not available: video is silent, audio "
                       "written to %s", sidecar)
        return sidecar
