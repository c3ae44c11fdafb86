"""float_torch.io.checkpoint / io.hf (numpy only) against the safetensors
package and against float_tpu's loaders, at tests/torch_parity.py's tiny
configs and, for the shape inference, at the published widths.

Tolerances: none.  Safetensors round trips are bit-equal for F32, F16,
BF16 (through its uint16 bits), I64 and I32; every loaded tree equals
float_tpu's leaf for leaf, bit for bit, with both weight-norm key styles;
``infer_*_arch`` returns equal dicts.

The helpers ``flatten``, ``unified_flat`` and ``write_hf_dir`` build a
unified checkpoint and HF folders; the other port test files import
them."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as pt_save_file

from float_tpu.io import checkpoint as j_ckpt
from float_tpu.io import hf as j_hf
from float_torch.config import FloatConfig
from float_torch.io import checkpoint as t_ckpt
from float_torch.io import hf as t_hf
from float_torch.models import init as t_init
from torch_parity import TINY, TINY_SER, TINY_W2V


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unified_flat(params) -> dict:
    """A pipeline params tree in the unified FLOAT.safetensors key layout
    (the emotion tower nested under ``wav2vec2.`` beside ``classifier.``)."""
    flat = {}
    flat.update(flatten(params["encoder"], "motion_autoencoder.enc"))
    flat.update(flatten(params["synthesis"], "motion_autoencoder.dec"))
    flat.update(flatten(params["audio_encoder"]["wav2vec2"],
                        "audio_encoder.wav2vec2"))
    flat.update(flatten(params["audio_encoder"]["audio_projection"],
                        "audio_encoder.audio_projection"))
    emo = dict(params["emotion"])
    cls = emo.pop("classifier")
    flat.update(flatten(emo, "emotion_encoder.wav2vec2_for_emotion.wav2vec2"))
    flat.update(flatten(cls,
                        "emotion_encoder.wav2vec2_for_emotion.classifier"))
    flat.update(flatten(params["fmt"], "fmt"))
    return flat


def hf_config(cfg, **extra) -> dict:
    return {"hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "intermediate_size": cfg.intermediate_size,
            "conv_dim": list(cfg.conv_dim),
            "conv_kernel": list(cfg.conv_kernel),
            "conv_stride": list(cfg.conv_stride),
            "conv_bias": cfg.conv_bias,
            "feat_extract_norm": cfg.feat_extract_norm,
            "do_stable_layer_norm": cfg.do_stable_layer_norm,
            "num_conv_pos_embeddings": cfg.num_conv_pos_embeddings,
            "num_conv_pos_embedding_groups":
                cfg.num_conv_pos_embedding_groups, **extra}


LABELS = ("angry", "disgust", "fear", "happy", "neutral", "sad", "surprise")


def write_hf_dir(d, cfg, flat_weights, save=t_ckpt.save_safetensors):
    """An HF folder: config.json (+ id2label for a classifier config) and
    model.safetensors."""
    d.mkdir(parents=True)
    extra = ({"id2label": {str(i): lbl for i, lbl in enumerate(LABELS)}}
             if cfg.num_labels else {})
    (d / "config.json").write_text(json.dumps(hf_config(cfg, **extra)))
    save(flat_weights, str(d / "model.safetensors"))
    return d


def weight_norm_split(flat, key, style):
    """Replace ``key`` (a conv1d weight) by a weight-norm pair: g = ||w||
    over dims (0, 1), v = w, under either key style."""
    w = flat.pop(key)
    g = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)
                ).astype(np.float32)
    prefix = key[: -len(".weight")]
    if style == "weight_g":
        flat[prefix + ".weight_g"], flat[prefix + ".weight_v"] = g, w
    else:
        flat[prefix + ".parametrizations.weight.original0"] = g
        flat[prefix + ".parametrizations.weight.original1"] = w
    return flat


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == np.float32 and g.shape == w.shape, (path, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}.{k}")


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}


def _tensors(tag):
    g = torch.Generator().manual_seed(len(tag))
    dt = DTYPES[tag]
    if dt.is_floating_point:
        mk = lambda *s: torch.randn(s, generator=g).to(dt)  # noqa: E731
    else:
        mk = lambda *s: torch.randint(-2 ** 30, 2 ** 30, s,  # noqa: E731
                                      generator=g).to(dt)
    return {"a.weight": mk(3, 5), "b": mk(7), "c.d": mk(2, 1, 4),
            "empty": mk(0, 3), "scalar": mk()}


def _as_f32_numpy(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_reader_reads_package_files(tag, tmp_path):
    ts = _tensors(tag)
    path = str(tmp_path / "x.safetensors")
    pt_save_file(ts, path, metadata={"format": "pt"})
    got = t_ckpt.load_safetensors(path)
    assert sorted(got) == sorted(ts)
    for k, t in ts.items():
        want = _as_f32_numpy(t)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_writer_read_by_package(tag, tmp_path):
    ts = _tensors(tag)
    path = str(tmp_path / "x.safetensors")
    if tag == "BF16":
        t_ckpt.save_safetensors(ts, path)
    else:   # numpy input, as the loaders pass it
        t_ckpt.save_safetensors({k: t.numpy() for k, t in ts.items()}, path)
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(ts)
        for k, t in ts.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and torch.equal(got, t)


def test_numpy_package_file_and_header_checks(tmp_path):
    """A file written by safetensors.numpy reads back equal; a header whose
    byte span disagrees with its shape is refused."""
    arrs = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
            "y": np.arange(5, dtype=np.int64)}
    path = str(tmp_path / "n.safetensors")
    np_save_file(arrs, path)
    got = t_ckpt.load_safetensors(path)
    for k in arrs:
        np.testing.assert_array_equal(got[k], arrs[k])
    raw = bytearray(open(path, "rb").read())
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    header["x"]["shape"] = [3, 5]
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(len(blob).to_bytes(8, "little") + blob + raw[8 + n:])
    with pytest.raises(ValueError, match="span"):
        t_ckpt.load_safetensors(str(bad))


# ---------------------------------------------------------------------------
# checkpoint layouts against float_tpu
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    return t_init.init_pipeline(TINY, TINY_W2V, TINY_SER, seed=0)


POS_CONV = "encoder.pos_conv_embed.conv.weight"


@pytest.mark.parametrize("style", ["weight_g", "parametrizations"])
def test_unified_checkpoint_matches_float_tpu(tiny_params, tmp_path, style):
    flat = unified_flat(tiny_params)
    # the unified file may carry the wav2vec2 positional conv weight-normed
    for tower in ("audio_encoder.wav2vec2",
                  "emotion_encoder.wav2vec2_for_emotion.wav2vec2"):
        weight_norm_split(flat, f"{tower}.{POS_CONV}", style)
    # config buffers the loaders drop
    flat["fmt.pos_embed"] = np.zeros((1, 13, 64), np.float32)
    flat["motion_autoencoder.dec.convs.0.noise.weight"] = np.zeros(1, np.float32)
    path = str(tmp_path / "FLOAT.safetensors")
    np_save_file(flat, path)
    got = t_ckpt.load_unified_checkpoint(path)
    assert_trees_equal(got, j_ckpt.load_unified_checkpoint(path))
    # the layout params_to_state_dict takes: one strict load
    skel = t_init.empty_pipeline(TINY, TINY_W2V, TINY_SER)
    skel.load_state_dict(t_init.params_to_state_dict(got), strict=True)
    np.testing.assert_array_equal(
        got["synthesis"]["convs"]["0"]["conv"]["weight"],
        tiny_params["synthesis"]["convs"]["0"]["conv"]["weight"])


def test_unified_state_dict_round_trip(tiny_params, tmp_path):
    """A pipeline's state_dict, renamed by unified_state_dict and written
    by the port, is the unified layout and loads back equal."""
    state = t_init.params_to_state_dict(tiny_params)
    flat = t_ckpt.unified_state_dict(state)
    assert sorted(flat) == sorted(unified_flat(tiny_params))
    path = str(tmp_path / "FLOAT.safetensors")
    t_ckpt.save_safetensors(flat, path)
    assert_trees_equal(t_ckpt.load_unified_checkpoint(path), tiny_params)
    assert_trees_equal(j_ckpt.load_unified_checkpoint(path), tiny_params)


@pytest.mark.parametrize("style", ["weight_g", "parametrizations"])
def test_legacy_pth_matches_float_tpu(tiny_params, tmp_path, style):
    flat = unified_flat(tiny_params)
    pth = {k: torch.from_numpy(v) for k, v in flat.items()
           if not k.startswith(("audio_encoder.wav2vec2.",
                                "emotion_encoder."))}
    torch.save({"state_dict": pth}, str(tmp_path / "float.pth"))
    w2v = weight_norm_split(flatten(tiny_params["audio_encoder"]["wav2vec2"]),
                            POS_CONV, style)
    emo = dict(tiny_params["emotion"])
    cls = emo.pop("classifier")
    ser = weight_norm_split(flatten(emo, "wav2vec2"), "wav2vec2." + POS_CONV,
                            style)
    ser.update(flatten(cls, "classifier"))
    write_hf_dir(tmp_path / "w2v", TINY_W2V, w2v, np_save_file)
    write_hf_dir(tmp_path / "ser", TINY_SER, ser, np_save_file)
    args = (str(tmp_path / "float.pth"), str(tmp_path / "w2v"),
            str(tmp_path / "ser"))
    assert_trees_equal(t_ckpt.load_legacy_checkpoint(*args),
                       j_ckpt.load_legacy_checkpoint(*args))


@pytest.mark.parametrize("weights", ["model.safetensors", "pytorch_model.bin"])
def test_load_wav2vec2_dir_matches_float_tpu(tiny_params, tmp_path, weights):
    emo = dict(tiny_params["emotion"])
    cls = emo.pop("classifier")
    flat = flatten(emo, "wav2vec2")
    flat.update(flatten(cls, "classifier"))
    d = write_hf_dir(tmp_path / "ser", TINY_SER, flat, np_save_file)
    if weights == "pytorch_model.bin":
        (d / "model.safetensors").unlink()
        torch.save({k: torch.from_numpy(v) for k, v in flat.items()},
                   str(d / weights))
    got_p, got_cfg, got_labels = t_hf.load_wav2vec2_dir(str(d))
    want_p, want_cfg, want_labels = j_hf.load_wav2vec2_dir(str(d))
    assert_trees_equal(got_p, want_p)
    assert got_labels == want_labels == dict(enumerate(LABELS))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg) \
        == dataclasses.asdict(TINY_SER)


# ---------------------------------------------------------------------------
# architecture inference
# ---------------------------------------------------------------------------

class _ShapeOnly:
    """Leaf maker for models.init: shape-only stand-ins (no memory), so the
    published widths' 617.5 M parameters cost nothing."""

    def __init__(self, seed=0, scale=0.0):
        pass

    def t(self, *shape, scale=None):
        return types.SimpleNamespace(shape=tuple(shape))

    zeros = ones = t


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat_shapes(v, key) if isinstance(v, dict) else {key: v})
    return out


PUBLISHED = FloatConfig()


def _parts(cfg, w2v_cfg, ser_cfg):
    p = t_init.init_pipeline(cfg, w2v_cfg, ser_cfg, mk=_ShapeOnly)
    return {"encoder": _flat_shapes(p["encoder"]),
            "synthesis": _flat_shapes(p["synthesis"]),
            "fmt": _flat_shapes(p["fmt"]),
            "projection": _flat_shapes(p["audio_encoder"]["audio_projection"])}


INFER = {"encoder": "infer_encoder_arch", "synthesis": "infer_synthesis_arch",
         "fmt": "infer_fmt_arch", "projection": "infer_projection_arch"}


@pytest.mark.parametrize("part", sorted(INFER))
@pytest.mark.parametrize("widths", ["tiny", "published"])
def test_infer_arch_matches_float_tpu(part, widths):
    from float_torch.config import WAV2VEC2_BASE, WAV2VEC2_LARGE_SER
    parts = (_parts(TINY, TINY_W2V, TINY_SER) if widths == "tiny"
             else _parts(PUBLISHED, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER))
    got = getattr(t_ckpt, INFER[part])(parts[part])
    assert got == getattr(j_ckpt, INFER[part])(parts[part])
    if widths == "published":
        want = {"encoder": {"input_size": 512, "dim": 512, "dim_motion": 20},
                "synthesis": {"size": 512, "style_dim": 512,
                              "motion_dim": 20},
                "fmt": {"dim_h": 1024, "dim_w": 512, "fmt_depth": 8,
                        "mlp_ratio": 4.0, "c_embedder_in": 512 + 512 + 7},
                "projection": {"input_dim": 9216, "output_dim": 512}}[part]
        assert {k: got[k] for k in want} == want
