"""Checkpoint files -> parameter trees, with numpy only (twin of
``float_tpu.io.checkpoint``).

Storage layouts:

- the unified ``FLOAT.safetensors`` with hierarchical keys
  (``motion_autoencoder.enc.*``, ``motion_autoencoder.dec.*``,
  ``audio_encoder.wav2vec2.*``, ``audio_encoder.audio_projection.*``,
  ``emotion_encoder.wav2vec2_for_emotion.*``, ``fmt.*``; reference
  tools/save_combined_tool.py:98-115);
- per-part safetensors files (encoder, decoder, projection, fmt) and two
  HuggingFace folders for the wav2vec2 towers (``io.hf``);
- the legacy ``float.pth`` torch state dict with the two HF folders.

The safetensors format is read and written here without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (the
reader skips an optional ``__metadata__`` entry), then the raw
little-endian tensor bytes, offsets counted from the end of the header.
Dtypes: F32, F16, BF16, I64 and I32.

At load time the keys are split on '.' into a nested dict with numpy
leaves in torch's layouts (``models.init.params_to_state_dict`` takes
it), weight-norm pairs are folded into plain weights, and buffers that
are functions of the config (blur ``kernel``, ``pos_embed``,
``alignment_mask``, ``masked_spec_embed``, ``num_batches_tracked``,
NoiseInjection's unused ``weight``) are dropped.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import CHANNELS_MAP

# buffers that are functions of config, never loaded
_DROP_LEAVES = {"kernel", "pos_embed", "alignment_mask", "masked_spec_embed",
                "num_batches_tracked"}
# NoiseInjection is identity at inference; its zero weight is unused
_DROP_SUFFIXES = (".noise.weight",)

# safetensors dtype tag -> numpy storage dtype.  BF16 has no numpy dtype:
# it is read as its raw uint16 bits and widened to float32.
_ST_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
              "I32": "<i4"}
_NP_TAGS = {np.dtype(v): k for k, v in _ST_DTYPES.items() if k != "BF16"}


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (uint16) -> float32, widened through torch."""
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).float().numpy()


def load_safetensors(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    """Read a safetensors file into a flat {key: np.ndarray} dict.

    Tensors are read-only views of a memory map of the file, except BF16
    ones, which are widened to float32 copies."""
    path = str(path)
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    n_data = os.path.getsize(path) - 8 - n
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
            if n_data else np.empty(0, np.uint8))
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        tag = info["dtype"]
        if tag not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {key!r} has unsupported "
                             f"dtype {tag}")
        begin, end = info["data_offsets"]
        dt = np.dtype(_ST_DTYPES[tag])
        shape = tuple(info["shape"])
        if (end - begin) != dt.itemsize * int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {key!r} spans {end - begin} "
                             f"bytes, its shape {shape} needs "
                             f"{dt.itemsize * int(np.prod(shape))}")
        arr = data[begin:end].view(dt).reshape(shape)
        out[key] = _bf16_to_f32(arr) if tag == "BF16" else arr
    return out


def _raw(value):
    """(safetensors dtype tag, contiguous numpy array of its bytes) for a
    numpy array or a torch tensor (torch's bfloat16 as its uint16 bits)."""
    if not isinstance(value, np.ndarray):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", t.view(torch.int16).numpy().view(np.uint16)
        value = t.numpy()
    arr = np.asarray(value, order="C")
    dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" \
        else arr.dtype
    if dt not in _NP_TAGS:
        raise ValueError(f"no safetensors dtype for {arr.dtype}")
    return _NP_TAGS[dt], arr.astype(dt, copy=False)


def save_safetensors(tensors: Mapping, path: str | os.PathLike) -> None:
    """Write {key: numpy array or torch tensor} as a safetensors file that
    the ``safetensors`` package reads (tensors in key order, the header
    padded with spaces to a multiple of 8 bytes)."""
    raws = {k: _raw(v) for k, v in sorted(tensors.items())}
    header: dict = {}
    off = 0
    for key, (tag, arr) in raws.items():
        header[key] = {"dtype": tag, "shape": list(arr.shape),
                       "data_offsets": [off, off + arr.nbytes]}
        off += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(str(path), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _tag, arr in raws.values():
            f.write(memoryview(arr.reshape(-1)).cast("B"))


def load_torch_pth(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    """Read a legacy torch .pth/.bin state dict into a flat numpy dict
    (``torch.load(weights_only=True)``; bfloat16 widened to float32).

    Covers the reference's legacy ``float.pth`` load path
    (generate.py:139-152); its wav2vec2 weights come from HF folders
    (io.hf.load_wav2vec2_dir)."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy()
            for k, v in sd.items() if hasattr(v, "detach")}


def load_legacy_checkpoint(pth_path: str, wav2vec_dir: str, ser_dir: str,
                           dtype=np.float32) -> dict:
    """Legacy layout: float.pth (motion AE + projection + fmt) + 2 HF
    folders (reference generate.py:139-152): non-wav2vec weights from the
    .pth, both towers from the HF folders."""
    from .hf import load_wav2vec2_dir
    flat = load_torch_pth(pth_path)
    parts = split_unified(flat)
    w2v_params, _w2v_cfg, _ = load_wav2vec2_dir(wav2vec_dir)
    ser_params, _ser_cfg, _ = load_wav2vec2_dir(ser_dir)
    return {
        "encoder": flat_to_pytree(parts["encoder"], dtype),
        "synthesis": flat_to_pytree(parts["synthesis"], dtype),
        "audio_encoder": {
            "wav2vec2": w2v_params,
            "audio_projection": flat_to_pytree(parts["audio_projection"],
                                               dtype),
        },
        "emotion": ser_params,
        "fmt": flat_to_pytree(parts["fmt"], dtype),
    }


def _fold_weight_norm(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight-norm pairs into plain weights.

    Handles ``<p>.weight_g``/``<p>.weight_v`` and
    ``<p>.parametrizations.weight.original0``/``original1`` (g, v).
    torch weight_norm(dim=2) for conv1d: w = g * v / ||v|| with the norm
    over dims (0, 1), per kernel position."""
    out = dict(flat)
    for key in list(flat):
        if key.endswith(".weight_g"):
            prefix = key[: -len(".weight_g")]
            g = out.pop(key)
            v = out.pop(prefix + ".weight_v")
        elif key.endswith(".parametrizations.weight.original0"):
            prefix = key[: -len(".parametrizations.weight.original0")]
            g = out.pop(key)
            v = out.pop(prefix + ".parametrizations.weight.original1")
        else:
            continue
        norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(0, 1),
                              keepdims=True))
        out[prefix + ".weight"] = (g * v / np.maximum(norm, 1e-12)).astype(
            v.dtype)
    return out


def flat_to_pytree(flat: Mapping[str, np.ndarray], dtype=np.float32) -> dict:
    """Flat torch-style keys -> nested dict with numpy leaves of ``dtype``
    (weight norm folded, config buffers dropped)."""
    flat = _fold_weight_norm(dict(flat))
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        if parts[-1] in _DROP_LEAVES:
            continue
        if any(key.endswith(s) for s in _DROP_SUFFIXES):
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value, dtype=dtype)
    return tree


def subtree(flat: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Select keys under ``prefix.`` and strip it."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in flat.items() if k.startswith(prefix + ".")}


# unified-checkpoint component prefixes (reference: utils/downloader.py:35-42)
UNIFIED_PREFIXES = {
    "encoder": "motion_autoencoder.enc",
    "synthesis": "motion_autoencoder.dec",
    "wav2vec2": "audio_encoder.wav2vec2",
    "audio_projection": "audio_encoder.audio_projection",
    "emotion": "emotion_encoder.wav2vec2_for_emotion",
    "fmt": "fmt",
}


def split_unified(flat: Mapping[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Unified checkpoint -> per-component flat dicts."""
    return {name: subtree(flat, pfx) for name, pfx in UNIFIED_PREFIXES.items()}


def unified_state_dict(state: Mapping) -> dict:
    """A pipeline's parameters under their state_dict keys (``encoder.*``,
    ``synthesis.*``, ``audio_encoder.{wav2vec2,audio_projection}.*``,
    ``emotion.*``, ``fmt.*``) -> the same values under the unified
    FLOAT.safetensors keys: what ``load_unified_checkpoint`` reads back (the
    emotion tower again under ``wav2vec2.`` beside ``classifier.``)."""
    out = {}
    for key, value in state.items():
        comp, _, rest = key.partition(".")
        if comp == "audio_encoder":
            comp, _, rest = rest.partition(".")
        elif comp == "emotion" and not rest.startswith("classifier."):
            rest = "wav2vec2." + rest
        out[f"{UNIFIED_PREFIXES[comp]}.{rest}"] = value
    return out


def load_unified_checkpoint(path: str | os.PathLike, dtype=np.float32) -> dict:
    """FLOAT.safetensors -> {component: tree} in the layout of
    ``models.init.init_pipeline``.

    The emotion tower's HF nesting (``wav2vec2.*`` beside ``classifier.*``
    in Wav2Vec2ForSpeechClassification) is flattened: the tower's keys and
    ``classifier`` side by side."""
    return params_from_parts(split_unified(load_safetensors(path)), dtype)


def params_from_parts(parts: Mapping[str, Mapping[str, np.ndarray]],
                      dtype=np.float32) -> dict:
    """Per-component flat dicts, keyed as ``split_unified`` keys them ->
    {component: tree} in the layout of ``models.init.init_pipeline``."""
    out = {
        "encoder": flat_to_pytree(parts["encoder"], dtype),
        "synthesis": flat_to_pytree(parts["synthesis"], dtype),
        "audio_encoder": {
            "wav2vec2": flat_to_pytree(parts["wav2vec2"], dtype),
            "audio_projection": flat_to_pytree(parts["audio_projection"],
                                               dtype),
        },
        "fmt": flat_to_pytree(parts["fmt"], dtype),
    }
    emo = flat_to_pytree(parts["emotion"], dtype)
    emo_params = dict(emo.get("wav2vec2", {}))
    if "classifier" in emo:
        emo_params["classifier"] = emo["classifier"]
    out["emotion"] = emo_params
    return out


# ---------------------------------------------------------------------------
# architecture from the shapes (reference: nodes_vadv_loader.py)
# ---------------------------------------------------------------------------

def infer_encoder_arch(flat: Mapping[str, np.ndarray]) -> dict:
    """Dims of an encoder checkpoint (reference:
    nodes_vadv_loader.py:341-473)."""
    dim_m = flat["fc.4.weight"].shape[0]
    dim_w = flat["fc.0.weight"].shape[0]
    first_out = flat["net_app.convs.0.0.weight"].shape[0]
    # first conv maps 3 -> CHANNELS_MAP[input_size]; smallest size wins ties
    sizes = sorted(s for s, c in CHANNELS_MAP.items() if c == first_out)
    if not sizes:
        raise ValueError(f"cannot infer input size from {first_out} channels")
    # the pyramid has log2(size) - 2 res blocks
    n_res = len({k.split(".")[2] for k in flat
                 if k.startswith("net_app.convs.")}) - 2
    return {"input_size": 2 ** (n_res + 2), "dim": dim_w, "dim_motion": dim_m,
            "first_conv_channels": first_out, "inv_map_size": sizes[-1]}


def infer_synthesis_arch(flat: Mapping[str, np.ndarray]) -> dict:
    """(reference: nodes_vadv_loader.py:476-652)."""
    style_dim = flat["conv1.conv.modulation.weight"].shape[1]
    motion_dim = flat["direction.weight"].shape[1]
    n_rgb = len({k.split(".")[1] for k in flat if k.startswith("to_rgbs.")})
    return {"size": 2 ** (n_rgb + 2), "style_dim": style_dim,
            "motion_dim": motion_dim}


def infer_fmt_arch(flat: Mapping[str, np.ndarray]) -> dict:
    """(reference: nodes_vadv_loader.py:655-866); dim_a is
    ``c_embedder_in - dim_w - dim_e``."""
    dim_h = flat["x_embedder.proj.weight"].shape[0]
    dim_w = flat["x_embedder.proj.weight"].shape[1]
    depth = 1 + max(int(k.split(".")[1]) for k in flat
                    if k.startswith("blocks."))
    mlp_hidden = flat["blocks.0.mlp.fc1.weight"].shape[0]
    c_in = flat["c_embedder.weight"].shape[1]
    return {"dim_h": dim_h, "dim_w": dim_w, "fmt_depth": depth,
            "mlp_ratio": mlp_hidden / dim_h, "c_embedder_in": c_in}


def infer_projection_arch(flat: Mapping[str, np.ndarray]) -> dict:
    """(reference: nodes_vadv_loader.py:159-257)."""
    w = flat["0.weight"]
    return {"input_dim": w.shape[1], "output_dim": w.shape[0]}
