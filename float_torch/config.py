"""Configuration of the FLOAT pipeline in PyTorch.

The port's own copy of the reference package's configuration: the live
fields of the reference ``BaseOptions`` dataclass (reference:
src/nodes/options/base_options.py:10-60) plus the ``ADV_FLOAT_DICT``
override surface (src/nodes/nodes_adv.py:130-235), with the same fields,
defaults and validation.

The config is a frozen dataclass: per-call overrides make a new config via
:meth:`FloatConfig.replace`, so one pipeline object never changes under a
caller that holds it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

# Emotion label set (reference: src/nodes/__init__.py:13, FLOAT.py:390)
EMOTION_LABELS = ("angry", "disgust", "fear", "happy", "neutral", "sad",
                  "surprise")
# UI adds "none" = predict from audio
EMOTIONS_UI = ("none",) + EMOTION_LABELS

# Fixed-step ODE solver whitelist (reference: src/nodes/__init__.py:15-23)
ODE_SOLVERS = ("euler", "midpoint", "rk4", "heun2", "heun3")

# StyleGAN2 channel map (reference: src/nodes/models/misc.py:1-11)
CHANNELS_MAP = {
    4: 512, 8: 512, 16: 512, 32: 512, 64: 256,
    128: 128, 256: 64, 512: 32, 1024: 16,
}

# RGBA conversion strategies (reference: src/nodes/utils/image.py:38-131)
RGBA_STRATEGIES = ("blend_with_color", "discard_alpha", "replace_with_color")


@dataclass(frozen=True)
class FloatConfig:
    """Static model / inference configuration (hashable, immutable)."""

    # --- geometry / modality dims (reference: base_options.py) ---
    input_size: int = 512
    input_nc: int = 3
    fps: float = 25.0
    sampling_rate: int = 16000
    wav2vec_sec: float = 2.0
    attention_window: int = 2
    only_last_features: bool = False

    dim_a: int = 512          # audio latent dim
    dim_w: int = 512          # appearance / motion latent dim
    dim_h: int = 1024         # FMT hidden
    dim_m: int = 20           # motion magnitude dim
    dim_e: int = 7            # emotion classes

    fmt_depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 4.0
    num_prev_frames: int = 10

    # dropout probs (training-only semantics; kept for parity of the API)
    audio_dropout_prob: float = 0.1
    ref_dropout_prob: float = 0.1
    emotion_dropout_prob: float = 0.1

    # --- ODE sampling ---
    nfe: int = 10
    ode_atol: float = 1e-5
    ode_rtol: float = 1e-5
    ode_method: str = "euler"

    # --- CFG scales ---
    a_cfg_scale: float = 2.0
    e_cfg_scale: float = 1.0
    r_cfg_scale: float = 1.0
    include_r_cfg: bool = False

    # --- seeding ---
    seed: int = 15
    fix_noise_seed: bool = True

    # --- preprocessing ---
    face_margin: float = 1.6
    rgba_conversion: str = "blend_with_color"
    bkg_color_hex: str = "#000000"

    # --- execution knobs (no reference equivalent) ---
    # dtype of the synthesis decode's convolutions and warps
    compute_dtype: str = "bfloat16"
    # storage dtype of the weights
    param_dtype: str = "float32"
    # frames decoded per synthesis forward (the last chunk shrinks to a
    # multiple of 4 covering the remainder)
    decode_batch: int = 8
    # kept so a configuration carries over between the two packages; the
    # port's decode takes its CUDA kernels on a CUDA device and the plain
    # PyTorch warps on the CPU whatever this says
    use_pallas: bool = True
    # FMT sampler dtype; float32 matches the reference's torch path
    sampler_dtype: str = "float32"
    # clips longer than this predict emotion over fixed-length windows
    # (scores averaged, weighted by window length): the full-clip
    # wav2vec2-large attention is O(T²)
    ser_max_sec: float = 60.0

    # --- derived ---
    @property
    def num_frames_for_clip(self) -> int:
        # reference: FMT.py:209
        return int(self.wav2vec_sec * self.fps)

    @property
    def num_total_frames(self) -> int:
        # reference: FMT.py:211
        return self.num_prev_frames + self.num_frames_for_clip

    @property
    def n_latent(self) -> int:
        # reference: styledecoder.py:495 (2*log2(size) - 2)
        return int(math.log2(self.input_size)) * 2 - 2

    def replace(self, **kw) -> "FloatConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "FloatConfig":
        if self.ode_method not in ODE_SOLVERS:
            raise ValueError(
                f"ode_method {self.ode_method!r} not in {ODE_SOLVERS}")
        if self.rgba_conversion not in RGBA_STRATEGIES:
            raise ValueError(
                f"rgba_conversion {self.rgba_conversion!r} not in "
                f"{RGBA_STRATEGIES}")
        if self.input_size not in CHANNELS_MAP:
            raise ValueError(f"input_size {self.input_size} unsupported")
        if self.dim_h % self.num_heads:
            raise ValueError("dim_h must be divisible by num_heads")
        return self


# The "advanced options" override dict keys, mirroring ADV_FLOAT_DICT
# (reference: nodes_adv.py:130-235), mapped onto FloatConfig field names.
ADV_KEY_MAP = {
    "r_cfg_scale": "r_cfg_scale",
    "attention_window": "attention_window",
    "audio_dropout_prob": "audio_dropout_prob",
    "ref_dropout_prob": "ref_dropout_prob",
    "emotion_dropout_prob": "emotion_dropout_prob",
    "ode_atol": "ode_atol",
    "ode_rtol": "ode_rtol",
    "nfe": "nfe",
    "torchdiffeq_ode_method": "ode_method",
    "face_margin": "face_margin",
    "rgba_conversion": "rgba_conversion",
    "bkg_color_hex": "bkg_color_hex",
}


def apply_adv_options(cfg: FloatConfig, adv: dict | None) -> FloatConfig:
    """Apply an ADV_FLOAT_DICT-style override dict onto a config.

    Explicit dict values override the dataclass defaults (reference
    nodes.py:113-122); unknown keys raise."""
    if not adv:
        return cfg
    updates = {}
    for k, v in adv.items():
        if k not in ADV_KEY_MAP:
            raise KeyError(f"unknown advanced option {k!r}")
        updates[ADV_KEY_MAP[k]] = v
    return cfg.replace(**updates).validate()


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture of the wav2vec2 towers (base and large-SER): the field
    subset of HF's Wav2Vec2Config that inference needs (reference configs:
    src/nodes/model_configs/wav2vec2_base/config.json and
    emotion_ser/config.json)."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"      # "group" (base) | "layer" (large)
    do_stable_layer_norm: bool = False    # False = post-LN, True = pre-LN
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    num_labels: int = 0                   # >0 for the SER classifier head

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


WAV2VEC2_BASE = Wav2Vec2Config()

WAV2VEC2_LARGE_SER = Wav2Vec2Config(
    hidden_size=1024,
    num_hidden_layers=24,
    num_attention_heads=16,
    intermediate_size=4096,
    conv_bias=True,
    feat_extract_norm="layer",
    do_stable_layer_norm=True,
    num_labels=7,
)
