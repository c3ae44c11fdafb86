"""Audio channel-mixing and resampling (reference: src/nodes/resample.py;
twin of ``float_tpu.audio.resample``, numpy and scipy only).

Parity contract:
- input is the ComfyUI AUDIO dict {'waveform': (B, C, N), 'sample_rate'},
- the first batch item is used, channels are averaged to mono
  (librosa.to_mono == mean over channels), output float32,
- resampling to 16 kHz.  The reference uses librosa/soxr 'soxr_hq'; here a
  polyphase windowed-sinc (Kaiser) filter via scipy.signal.resample_poly —
  equivalent quality class, no librosa/soxr dependency.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
from scipy.signal import resample_poly


def to_mono(wave: np.ndarray) -> np.ndarray:
    """(C, N) or (N,) -> (N,) float32 by channel mean."""
    w = np.asarray(wave)
    if w.ndim == 2:
        if w.shape[0] > 1:
            w = w.mean(axis=0)
        else:
            w = w[0]
    return np.ascontiguousarray(w, dtype=np.float32)


def resample(wave: np.ndarray, sr_in: int, sr_out: int = 16000) -> np.ndarray:
    """High-quality polyphase resample (N,) float32 -> (M,) float32."""
    if sr_in == sr_out:
        return np.ascontiguousarray(wave, dtype=np.float32)
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    out = resample_poly(wave.astype(np.float64), up, down,
                        window=("kaiser", 14.769656459379492))
    return np.ascontiguousarray(out, dtype=np.float32)


def read_wav_file(path: str):
    """PCM wav file -> ((C, N) float32 in [-1, 1], sample_rate).

    Handles 8-bit unsigned, 16-bit, 24-bit and 32-bit integer PCM (the
    stdlib ``wave`` module's supported encodings) — shared by the CLI,
    the workflow runner and the graph LoadAudio adapter so sample-width
    handling lives in exactly one place.
    """
    import wave as wavmod
    with wavmod.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 1:                       # unsigned 8-bit
        arr = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
               - 128.0) / 128.0
    elif width == 2:
        arr = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 3:                     # packed 24-bit little-endian
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 & 0x800000, i32 - 0x1000000, i32)
        arr = i32.astype(np.float32) / 8388608.0
    elif width == 4:
        arr = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported wav sample width {width} in {path}")
    return np.ascontiguousarray(arr.reshape(-1, ch).T), sr


def comfy_audio_to_mono_16k(audio: Mapping, target_sr: int = 16000) -> np.ndarray:
    """ComfyUI AUDIO dict -> mono float32 at target_sr.

    Mirrors comfy_audio_to_librosa_mono + resample
    (reference: resample.py:95-151): first batch item, channel mean,
    float32, resample.
    """
    wave = np.asarray(audio["waveform"])
    sr = int(audio["sample_rate"])
    if wave.ndim == 3:
        wave = wave[0]                  # first batch item (B, C, N) -> (C, N)
    mono = to_mono(wave)
    return resample(mono, sr, target_sr)
