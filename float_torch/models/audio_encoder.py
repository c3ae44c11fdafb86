"""AudioEncoder — wav2vec2-base features -> projected audio latents wa
(twin of ``float_tpu.models.audio_encoder``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import FloatConfig, Wav2Vec2Config
from .wav2vec2 import _layer_norm, _linear, wav2vec2_frame_features


def pad_wave_to_frames(wave, seq_len: int, cfg: FloatConfig):
    """Edge-replicate pad (B, N) to int(seq_len * sr / fps) samples
    (reference FLOAT.py:370-373)."""
    target = int(seq_len * cfg.sampling_rate / cfg.fps)
    n = wave.shape[1]
    if n == target:
        return wave
    if n > target:
        raise ValueError(f"wave length {n} exceeds target {target}")
    return F.pad(wave[:, None], (0, target - n), mode="replicate")[:, 0]


def stacked_features(params, wave, seq_len: int, w2v_cfg: Wav2Vec2Config,
                     only_last_features: bool = False):
    """wav2vec2 features for the projection: the transformer layer outputs
    stacked per frame, [layer1 | ... | layerL] (B, T, L*H), or the last
    hidden state (B, T, H) (reference FLOAT.py:345-352)."""
    out = wav2vec2_frame_features(params, wave, seq_len, w2v_cfg,
                                  collect_hidden=not only_last_features)
    if only_last_features:
        return out.last_hidden_state
    return torch.cat(out.hidden_states[1:], dim=-1)


def audio_projection(params, feats):
    """Linear -> LayerNorm -> SiLU (reference FLOAT.py:338-342)."""
    return F.silu(_layer_norm(params["1"], _linear(params["0"], feats)))


def encode_audio(params, wave, seq_len: int, cfg: FloatConfig,
                 w2v_cfg: Wav2Vec2Config):
    """wave (B, N) -> wa (B, seq_len, dim_w) (reference FLOAT.py:370-375).

    Unless ``only_last_features``, the projection reads the transformer
    layer outputs stacked per frame, [layer1 | ... | layerL]."""
    wave = pad_wave_to_frames(wave, seq_len, cfg)
    feats = stacked_features(params["wav2vec2"], wave, seq_len, w2v_cfg,
                             cfg.only_last_features)
    return audio_projection(params["audio_projection"], feats)

