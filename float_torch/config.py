"""Configuration, shared with ``float_tpu``.

``float_tpu.config`` holds only frozen dataclasses and constants and does
not import JAX, so the port re-exports it instead of keeping a copy.
"""
from float_tpu.config import (  # noqa: F401
    CHANNELS_MAP, EMOTION_LABELS, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
    FloatConfig, Wav2Vec2Config,
)

__all__ = ["CHANNELS_MAP", "EMOTION_LABELS", "WAV2VEC2_BASE",
           "WAV2VEC2_LARGE_SER", "FloatConfig", "Wav2Vec2Config"]
