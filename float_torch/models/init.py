"""Random parameter initialisation and the parameter-tree module.

The ``init_*`` functions draw the same ``numpy.random.default_rng`` values,
in the same order and with the same seeds, as ``float_tpu.models.init``,
so synthetic weights are bit-identical across the two packages without
JAX.  They return nested dicts of float32 numpy arrays whose key paths
mirror the reference checkpoints.

The same functions, given :class:`_Empty` as leaf maker, give the tree's
skeleton of uninitialised tensors; :class:`ParamTree` turns either tree
into an ``nn.Module`` whose parameter names are the flattened key paths
(``convs.0.conv.weight``), so :func:`params_to_state_dict` output loads
with one ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
from torch import nn

from ..config import CHANNELS_MAP, FloatConfig, Wav2Vec2Config


class _Init:
    """Leaf maker: seeded standard-normal draws times ``scale``."""

    def __init__(self, seed: int, scale: float = 0.05):
        self.rng = np.random.default_rng(seed)
        self.scale = scale

    def t(self, *shape, scale=None):
        s = self.scale if scale is None else scale
        return self.rng.standard_normal(shape).astype(np.float32) * s

    def zeros(self, *shape):
        return np.zeros(shape, np.float32)

    def ones(self, *shape):
        return np.ones(shape, np.float32)


class _Empty:
    """Leaf maker: uninitialised tensors (a skeleton to load weights into)."""

    def __init__(self, seed: int = 0, scale: float = 0.0, device=None):
        self.device = device

    def t(self, *shape, scale=None):
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    zeros = ones = t


def init_encoder(size: int = 512, dim: int = 512, dim_m: int = 20,
                 seed: int = 0, mk=_Init):
    """Params for models.encoder (keys: motion_autoencoder.enc.*)."""
    g = mk(seed)
    log = int(math.log2(size))
    convs = {
        "0": {"0": {"weight": g.t(CHANNELS_MAP[size], 3, 1, 1, scale=1.0)},
              "1": {"bias": g.zeros(1, CHANNELS_MAP[size], 1, 1)}},
    }
    inc = CHANNELS_MAP[size]
    for n, i in enumerate(range(log, 2, -1)):
        outc = CHANNELS_MAP[2 ** (i - 1)]
        convs[str(n + 1)] = {
            "conv1": {"0": {"weight": g.t(inc, inc, 3, 3, scale=1.0)},
                      "1": {"bias": g.zeros(1, inc, 1, 1)}},
            "conv2": {"1": {"weight": g.t(outc, inc, 3, 3, scale=1.0)},
                      "2": {"bias": g.zeros(1, outc, 1, 1)}},
            "skip": {"1": {"weight": g.t(outc, inc, 1, 1, scale=1.0)}},
        }
        inc = outc
    convs[str(log - 1)] = {"weight": g.t(dim, inc, 4, 4, scale=1.0)}
    fc = {str(i): {"weight": g.t(dim if i < 4 else dim_m, dim, scale=1.0),
                   "bias": g.zeros(dim if i < 4 else dim_m)}
          for i in range(5)}
    return {"net_app": {"convs": convs}, "fc": fc}


def init_synthesis(size: int = 512, style_dim: int = 512, dim_m: int = 20,
                   seed: int = 1, mk=_Init):
    """Params for models.synthesis (keys: motion_autoencoder.dec.*)."""
    g = mk(seed)
    log = int(math.log2(size))

    def styled(inc, outc):
        return {"conv": {"weight": g.t(1, outc, inc, 3, 3, scale=1.0),
                         "modulation": {"weight": g.t(inc, style_dim, scale=1.0),
                                        "bias": g.ones(inc)}},
                "activate": {"bias": g.zeros(1, outc, 1, 1)}}

    p = {"direction": {"weight": g.t(style_dim, dim_m, scale=1.0)},
         "input": {"input": g.t(1, CHANNELS_MAP[4], 4, 4, scale=1.0)},
         "conv1": styled(CHANNELS_MAP[4], CHANNELS_MAP[4]),
         "convs": {}, "to_rgbs": {}, "to_flows": {}}
    inc = CHANNELS_MAP[4]
    for lvl in range(log - 2):
        outc = CHANNELS_MAP[2 ** (lvl + 3)]
        p["convs"][str(2 * lvl)] = styled(inc, outc)
        p["convs"][str(2 * lvl + 1)] = styled(outc, outc)
        p["to_rgbs"][str(lvl)] = {
            "conv": {"0": {"weight": g.t(3, outc, 1, 1, scale=1.0)},
                     "1": {"bias": g.zeros(1, 3, 1, 1)}},
            "bias": g.zeros(1, 3, 1, 1)}
        p["to_flows"][str(lvl)] = {
            # small flow-head weights: random tanh flows would span the
            # whole image, which no trained talking-head model does
            "conv": {"weight": g.t(1, 3, outc, 1, 1, scale=0.002),
                     "modulation": {"weight": g.t(outc, style_dim, scale=1.0),
                                    "bias": g.ones(outc)}},
            "bias": g.zeros(1, 3, 1, 1)}
        inc = outc
    return p


def init_fmt(cfg: FloatConfig, seed: int = 2, mk=_Init):
    """Params for models.fmt (keys: fmt.*)."""
    g = mk(seed, scale=0.02)
    h, w, a, e = cfg.dim_h, cfg.dim_w, cfg.dim_a, cfg.dim_e
    mlp_hidden = int(h * cfg.mlp_ratio)

    def lin(o, i):
        return {"weight": g.t(o, i, scale=1.0 / math.sqrt(i)), "bias": g.zeros(o)}

    blocks = {}
    for i in range(cfg.fmt_depth):
        blocks[str(i)] = {
            "attn": {"qkv": lin(3 * h, h), "proj": lin(h, h)},
            "mlp": {"fc1": lin(mlp_hidden, h), "fc2": lin(h, mlp_hidden)},
            "adaLN_modulation": {"1": {"weight": g.t(6 * h, h, scale=0.02),
                                       "bias": g.zeros(6 * h)}},
        }
    return {
        "x_embedder": {"proj": lin(h, w)},
        "t_embedder": {"mlp": {"0": lin(h, 256), "2": lin(h, h)}},
        "c_embedder": lin(h, w + a + e),
        "blocks": blocks,
        "decoder": {"adaLN_modulation": {"1": {"weight": g.t(2 * h, h, scale=0.02),
                                               "bias": g.zeros(2 * h)}},
                    "linear": lin(w, h)},
    }


def init_wav2vec2(cfg: Wav2Vec2Config, seed: int = 3, mk=_Init):
    """Params for models.wav2vec2 (keys: HF Wav2Vec2Model state_dict
    layout; the positional conv's weight norm is pre-folded)."""
    g = mk(seed, scale=0.02)
    h = cfg.hidden_size

    def lin(o, i):
        return {"weight": g.t(o, i, scale=1.0 / math.sqrt(i)), "bias": g.zeros(o)}

    def ln(d):
        return {"weight": g.ones(d), "bias": g.zeros(d)}

    conv_layers = {}
    in_c = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        layer = {"conv": {"weight": g.t(dim, in_c, k, scale=1.0 / math.sqrt(in_c * k))}}
        if cfg.conv_bias:
            layer["conv"]["bias"] = g.zeros(dim)
        if cfg.feat_extract_norm == "group" and i == 0:
            layer["layer_norm"] = ln(dim)          # GroupNorm affine params
        elif cfg.feat_extract_norm == "layer":
            layer["layer_norm"] = ln(dim)
        conv_layers[str(i)] = layer
        in_c = dim

    layers = {}
    for i in range(cfg.num_hidden_layers):
        layers[str(i)] = {
            "attention": {"q_proj": lin(h, h), "k_proj": lin(h, h),
                          "v_proj": lin(h, h), "out_proj": lin(h, h)},
            "layer_norm": ln(h),
            "feed_forward": {"intermediate_dense": lin(cfg.intermediate_size, h),
                             "output_dense": lin(h, cfg.intermediate_size)},
            "final_layer_norm": ln(h),
        }

    params = {
        "feature_extractor": {"conv_layers": conv_layers},
        "feature_projection": {"layer_norm": ln(cfg.conv_dim[-1]),
                               "projection": lin(h, cfg.conv_dim[-1])},
        "encoder": {
            "pos_conv_embed": {"conv": {
                "weight": g.t(h, h // cfg.num_conv_pos_embedding_groups,
                              cfg.num_conv_pos_embeddings, scale=0.02),
                "bias": g.zeros(h)}},
            "layer_norm": ln(h),
            "layers": layers,
        },
    }
    if cfg.num_labels:
        params["classifier"] = {"dense": lin(h, h),
                                "out_proj": lin(cfg.num_labels, h)}
    return params


def init_audio_projection(in_dim: int = 9216, out_dim: int = 512,
                          seed: int = 4, mk=_Init):
    """audio_projection Sequential(Linear, LayerNorm, SiLU) params
    (keys: audio_encoder.audio_projection.{0,1}.*)."""
    g = mk(seed)
    return {"0": {"weight": g.t(out_dim, in_dim, scale=1.0 / math.sqrt(in_dim)),
                  "bias": g.zeros(out_dim)},
            "1": {"weight": g.ones(out_dim), "bias": g.zeros(out_dim)}}


def init_pipeline(cfg: FloatConfig, w2v_cfg: Wav2Vec2Config,
                  ser_cfg: Wav2Vec2Config, seed: int = 0, mk=_Init):
    """The whole pipeline's params, seeded as float_tpu's
    ``build_synthetic_pipeline`` seeds them."""
    proj_in = (w2v_cfg.hidden_size if cfg.only_last_features
               else w2v_cfg.num_hidden_layers * w2v_cfg.hidden_size)
    return {
        "encoder": init_encoder(cfg.input_size, cfg.dim_w, cfg.dim_m, seed, mk),
        "synthesis": init_synthesis(cfg.input_size, cfg.dim_w, cfg.dim_m,
                                    seed + 1, mk),
        "audio_encoder": {
            "wav2vec2": init_wav2vec2(w2v_cfg, seed + 2, mk),
            "audio_projection": init_audio_projection(proj_in, cfg.dim_w,
                                                      seed + 3, mk),
        },
        "emotion": init_wav2vec2(ser_cfg, seed + 4, mk),
        "fmt": init_fmt(cfg, seed + 5, mk),
    }


def empty_pipeline(cfg: FloatConfig, w2v_cfg: Wav2Vec2Config,
                   ser_cfg: Wav2Vec2Config, device=None) -> "ParamTree":
    """Uninitialised pipeline parameters on ``device``, ready for
    ``load_state_dict``."""
    return ParamTree(init_pipeline(cfg, w2v_cfg, ser_cfg,
                                   mk=partial(_Empty, device=device)))


class ParamTree(nn.Module):
    """A nested dict of parameters as a module tree.

    ``tree[key]`` returns a child tree or a parameter, so model functions
    index it exactly as they index a plain nested dict of tensors.
    Parameters do not require grad: the pipeline only serves.
    ``tp_shards``: a layer's tensor-parallel slices, one dict a model rank
    (``parallel.sharding``); None for a layer held whole.
    ``chunk_graphs``: the FMT's ``runtime.sampling.ChunkGraphs``, its
    sampler chunks as CUDA graphs, made at the first chunk sampled on the
    card; freed with the tree.
    """

    tp_shards = None
    chunk_graphs = None

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def params_to_state_dict(tree: dict, prefix: str = "") -> dict:
    """Flatten a ``float_tpu`` params pytree (numpy or array-like leaves)
    into ``{dotted.key.path: tensor}``, the port's state_dict layout."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(params_to_state_dict(v, name + "."))
        else:
            out[name] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


def tree_to_module(tree: dict, device=None) -> ParamTree:
    """A :class:`ParamTree` on ``device`` holding float32 copies of a
    nested dict's array leaves (a model whose shapes were read from its
    checkpoint, so no skeleton to load into)."""
    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)
    return ParamTree(copy(tree))
