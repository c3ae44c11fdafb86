"""Node-surface datatypes — the contracts the reference's custom ComfyUI
types carry (SURVEY Appendix A), as plain dataclasses (twin of
``float_tpu.api.types``).

Conventions (ComfyUI parity):
- IMAGE: numpy (B, H, W, C) float32 [0, 1] RGB;
- AUDIO: {'waveform': (B, C, N), 'sample_rate': int};
- latents are torch tensors on the model's device with the shapes noted
  per field; models are :class:`~float_torch.models.init.ParamTree`
  modules on their device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from ..audio.features import DEFAULT_FE, FeatureExtractorConfig
from ..config import FloatConfig, Wav2Vec2Config


@dataclass
class FloatPipe:
    """FLOAT_PIPE: the full pipeline handle (InferenceAgent equivalent)."""
    pipeline: Any                       # runtime.pipeline.FloatPipeline
    cfg: FloatConfig
    weights: str = "unknown"            # "real" | "synthetic"
    # the DataProcessor's Wav2Vec2FeatureExtractor settings (reference:
    # generate.py:42-67 — bundled preprocessor_config.json by default)
    fe: FeatureExtractorConfig = DEFAULT_FE


@dataclass
class AppearancePipe:
    """FLOAT_APPEARANCE_PIPE: {h_source (B, dim_w), feats [7 maps]}."""
    h_source: Any
    feats: List[Any]


@dataclass
class Wav2VecPipe:
    """WAV2VEC_PIPE: (model params, feature extractor, config) + sr
    metadata (reference: nodes_vadv_loader.py:82,151 — the pipe carries
    the model folder's own Wav2Vec2FeatureExtractor)."""
    params: Any                         # ParamTree
    config: Wav2Vec2Config
    fe: FeatureExtractorConfig = DEFAULT_FE

    @property
    def expected_sr(self) -> int:
        return self.fe.sampling_rate


@dataclass
class EmotionModelPipe:
    """EMOTION_MODEL_PIPE: (SER params, feature extractor, config, label
    maps) (reference: nodes_vadv_loader.py:282,335)."""
    params: Any                         # ParamTree
    config: Wav2Vec2Config
    id2label: Dict[int, str] = field(default_factory=dict)
    fe: FeatureExtractorConfig = DEFAULT_FE

    @property
    def label2id(self) -> Dict[str, int]:
        return {v: k for k, v in self.id2label.items()}

    @property
    def dim_e(self) -> int:
        return self.config.num_labels or len(self.id2label)


@dataclass
class AudioProjectionLayer:
    """AUDIO_PROJECTION_LAYER: Sequential(Linear, LayerNorm, SiLU) params."""
    params: Any                         # ParamTree
    input_dim: int
    output_dim: int


@dataclass
class EncoderModel:
    """FLOAT_ENCODER_MODEL: encoder params + inferred architecture."""
    params: Any                         # ParamTree
    input_size: int
    dim: int
    dim_motion: int


@dataclass
class SynthesisModel:
    """FLOAT_SYNTHESIS_MODEL: synthesis params + inferred architecture."""
    params: Any                         # ParamTree
    size: int
    style_dim: int
    motion_dim: int
    blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    channel_multiplier: int = 1


@dataclass
class FMTModel:
    """FLOAT_FMT_MODEL: FMT params + construction options snapshot."""
    params: Any                         # ParamTree
    cfg: FloatConfig                    # carries dim/depth/window/fps fields
    construction_options: Dict[str, Any] = field(default_factory=dict)


BBox = Tuple[int, int, int, int]        # (x, y, w, h) square face box
