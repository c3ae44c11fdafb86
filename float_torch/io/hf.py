"""HuggingFace-format wav2vec2 model folders -> parameter trees (twin of
``float_tpu.io.hf``).

The counterpart of the reference's from_pretrained paths
(LoadWav2VecModel / LoadEmotionRecognitionModel,
nodes_vadv_loader.py:60-156, 260-338) without instantiating transformers
models: config.json -> Wav2Vec2Config, the weight file -> a tree with
numpy leaves via io.checkpoint (weight norm folded, buffers dropped).
"""
from __future__ import annotations

import json
import os
from typing import Tuple

from ..config import Wav2Vec2Config
from .checkpoint import flat_to_pytree, load_safetensors, load_torch_pth, subtree


def config_from_json(path: str) -> Wav2Vec2Config:
    with open(path) as f:
        raw = json.load(f)
    return Wav2Vec2Config(
        hidden_size=raw["hidden_size"],
        num_hidden_layers=raw["num_hidden_layers"],
        num_attention_heads=raw["num_attention_heads"],
        intermediate_size=raw["intermediate_size"],
        conv_dim=tuple(raw["conv_dim"]),
        conv_kernel=tuple(raw["conv_kernel"]),
        conv_stride=tuple(raw["conv_stride"]),
        conv_bias=raw.get("conv_bias", False),
        feat_extract_norm=raw.get("feat_extract_norm", "group"),
        do_stable_layer_norm=raw.get("do_stable_layer_norm", False),
        num_conv_pos_embeddings=raw.get("num_conv_pos_embeddings", 128),
        num_conv_pos_embedding_groups=raw.get("num_conv_pos_embedding_groups",
                                              16),
        layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
        num_labels=len(raw.get("id2label", {})) if raw.get("id2label") else 0,
    )


def load_state_dict_file(model_dir: str) -> dict:
    """Read model.safetensors, else pytorch_model.bin, from an HF folder."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return load_safetensors(st)
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return load_torch_pth(bin_path)
    raise FileNotFoundError(f"no weights found in {model_dir}")


def load_wav2vec2_dir(model_dir: str) -> Tuple[dict, Wav2Vec2Config, dict]:
    """HF folder -> (params tree, config, id2label or {}).

    Takes bare Wav2Vec2Model checkpoints and classifier checkpoints (keys
    under ``wav2vec2.`` beside ``classifier.``)."""
    cfg_path = os.path.join(model_dir, "config.json")
    cfg = config_from_json(cfg_path)
    flat = load_state_dict_file(model_dir)
    with open(cfg_path) as f:
        raw = json.load(f)
    id2label = {int(k): v for k, v in raw.get("id2label", {}).items()} \
        if raw.get("id2label") else {}

    if any(k.startswith("wav2vec2.") for k in flat):
        params = flat_to_pytree(subtree(flat, "wav2vec2"))
        cls = subtree(flat, "classifier")
        if cls:
            params["classifier"] = flat_to_pytree(cls)
    else:
        params = flat_to_pytree(flat)
    return params, cfg, id2label
