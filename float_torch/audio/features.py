"""Waveform feature normalization — Wav2Vec2FeatureExtractor equivalent
(twin of ``float_tpu.audio.features``, numpy only).

The reference loads HF's Wav2Vec2FeatureExtractor from a
``preprocessor_config.json`` — the bundled one for the unified path, the
model dir's own for the VA loader path (reference: generate.py:42-67,
nodes_vadv_loader.py:116-156) — and applies its settings (do_normalize,
padding_value, sampling_rate).  :class:`FeatureExtractorConfig` carries
those settings here; the default matches the reference's bundled config
(model_configs/wav2vec2_base/preprocessor_config.json: do_normalize=true,
padding_value=0.0, return_attention_mask=false, sampling_rate=16000).

Batch mode zero-pads to the longest item and normalizes the padded signal
(HF parity for return_attention_mask=false).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

_VAR_EPS = 1e-7


@dataclass(frozen=True)
class FeatureExtractorConfig:
    """The Wav2Vec2FeatureExtractor settings the inference path honors."""
    do_normalize: bool = True
    padding_value: float = 0.0
    sampling_rate: int = 16000
    return_attention_mask: bool = False
    feature_size: int = 1
    padding_side: str = "right"


DEFAULT_FE = FeatureExtractorConfig()


def load_preprocessor_config(model_dir: str) -> FeatureExtractorConfig:
    """Read ``preprocessor_config.json`` from a model dir.

    Mirrors Wav2Vec2FeatureExtractor.from_pretrained (reference:
    generate.py:62, nodes_vadv_loader.py:139).  Raises FileNotFoundError
    when the file is missing, like the reference's DataProcessor
    (generate.py:52-55).
    """
    path = os.path.join(model_dir, "preprocessor_config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Preprocessor config not found: {path}")
    with open(path) as f:
        raw = json.load(f)
    return FeatureExtractorConfig(
        do_normalize=bool(raw.get("do_normalize", True)),
        padding_value=float(raw.get("padding_value", 0.0)),
        sampling_rate=int(raw.get("sampling_rate", 16000)),
        return_attention_mask=bool(raw.get("return_attention_mask", False)),
        feature_size=int(raw.get("feature_size", 1)),
        padding_side=str(raw.get("padding_side", "right")),
    )


def normalize_waveform(wave: np.ndarray,
                       fe: FeatureExtractorConfig = DEFAULT_FE) -> np.ndarray:
    """(N,) -> float32 input_values under the extractor config.

    do_normalize=True: zero-mean / unit-variance (eps=1e-7, HF parity);
    do_normalize=False: pass through unchanged (dtype cast only).
    """
    w = np.asarray(wave, dtype=np.float32)
    if not fe.do_normalize:
        return w
    mean = w.mean()
    var = w.var()
    return ((w - mean) / np.sqrt(var + _VAR_EPS)).astype(np.float32)


def extract_features(waves: Sequence[np.ndarray],
                     fe: Optional[FeatureExtractorConfig] = None,
                     return_mask: bool = False):
    """Batch of (N_i,) -> (B, N_max) padded + normalized input_values.

    Matches Wav2Vec2FeatureExtractor(..., padding=True) in BOTH modes:

    - return_attention_mask=false (the bundled base config): items are
      padded FIRST (with ``padding_value``) and normalization — when
      ``do_normalize`` — runs over the padded signal, pad values included;
    - return_attention_mask=true (xlsr-style SER configs): each item is
      normalized over its OWN samples, THEN padded — the attention mask
      marks the real samples (HF normalizes before padding in this mode).

    ``return_mask=True`` additionally returns the (B, N_max) int32
    attention mask (all-ones when the config doesn't use masks).
    """
    fe = fe or DEFAULT_FE
    n_max = max(len(w) for w in waves)
    out = np.full((len(waves), n_max), fe.padding_value, np.float32)
    mask = np.zeros((len(waves), n_max), np.int32)
    for i, w in enumerate(waves):
        if fe.return_attention_mask:
            w = normalize_waveform(w, fe)
        sl = (slice(n_max - len(w), None) if fe.padding_side == "left"
              else slice(None, len(w)))
        out[i, sl] = w
        mask[i, sl] = 1
        if not fe.return_attention_mask:
            out[i] = normalize_waveform(out[i], fe)
            mask[i] = 1
    if return_mask:
        return out, mask
    return out
