"""wav2vec2 towers (twin of ``float_tpu.models.wav2vec2``): the audio
content encoder (base: group-norm first conv, post-LN blocks) and the SER
emotion encoder (large: layer-norm conv stack, pre-LN blocks with a final
LayerNorm, mean pool + classifier).  Param trees follow the HF state_dict
layout; the positional conv's weight norm is folded.

Attention is written out as matmul + softmax (+ additive key bias).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import Wav2Vec2Config
from ..ops import linear_interpolate_time
from ..parallel.sharding import row_parallel


def _linear(p, x):
    out = F.linear(x, p["weight"].to(x.dtype))
    return out + p["bias"].to(x.dtype)


def _layer_norm(p, x, eps=1e-5):
    y = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def _conv1d(x, w, b=None, stride=1, padding=0, groups=1):
    """x (B, C, T), w (O, I/groups, K) torch layout."""
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding, groups=groups)


def feature_extractor(params, wave, cfg: Wav2Vec2Config):
    """wave (B, N) -> conv features (B, T_conv, conv_dim[-1])."""
    x = wave[:, None, :]
    for i, s in enumerate(cfg.conv_stride):
        p = params["conv_layers"][str(i)]
        x = _conv1d(x, p["conv"]["weight"], p["conv"].get("bias"), stride=s)
        if cfg.feat_extract_norm == "group" and i == 0:
            # GroupNorm(groups=C): per-channel normalisation over time
            xf = x.float()
            mu = xf.mean(dim=2, keepdim=True)
            var = xf.var(dim=2, unbiased=False, keepdim=True)
            xf = (xf - mu) * torch.rsqrt(var + 1e-5)
            x = (xf * p["layer_norm"]["weight"].reshape(1, -1, 1)
                 + p["layer_norm"]["bias"].reshape(1, -1, 1)).to(x.dtype)
        elif cfg.feat_extract_norm == "layer":
            x = _layer_norm(p["layer_norm"], x.transpose(1, 2)).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _pos_conv_embed(params, x, cfg: Wav2Vec2Config):
    """Grouped positional conv (pad K/2, drop the trailing sample for an
    even K), GELU."""
    p = params["conv"]
    h = _conv1d(x.transpose(1, 2), p["weight"], p.get("bias"),
                padding=cfg.num_conv_pos_embeddings // 2,
                groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        h = h[:, :, :-1]
    return F.gelu(h).transpose(1, 2)


def _heads(p, x, heads: int, bias=None):
    """Attention of the ``heads`` heads whose rows ``p``'s q/k/v_proj hold
    -> (B, T, heads * hd), the input of ``out_proj``."""
    b, t, _ = x.shape
    hd = p["q_proj"]["weight"].shape[0] // heads
    q = _linear(p["q_proj"], x) * (hd ** -0.5)
    k = _linear(p["k_proj"], x)
    v = _linear(p["v_proj"], x)
    q, k, v = (a.reshape(b, t, heads, hd).transpose(1, 2)
               for a in (q, k, v))
    logits = (q @ k.transpose(-1, -2)).float()
    if bias is not None:
        logits = logits + bias
    att = torch.softmax(logits, dim=-1).to(x.dtype)
    return (att @ v).transpose(1, 2).reshape(b, t, heads * hd)


def _attention(p, x, num_heads: int, bias=None):
    shards = getattr(p, "tp_shards", None)
    if shards:                 # one head group a model rank (parallel/)
        heads = num_heads // len(shards)

        def part(s, xs):
            bs = None if bias is None else bias.to(xs.device)
            return F.linear(_heads(s, xs, heads, bs),
                            s["out_proj"]["weight"].to(xs.dtype))
        return row_parallel(shards, x, part, p["out_proj"]["bias"])
    return _linear(p["out_proj"], _heads(p, x, num_heads, bias))


def _feed_forward(p, x):
    shards = getattr(p, "tp_shards", None)
    if shards:                 # a slice of the intermediate width a rank
        return row_parallel(shards, x, lambda s, xs: F.linear(
            F.gelu(_linear(s["intermediate_dense"], xs)),
            s["output_dense"]["weight"].to(xs.dtype)),
            p["output_dense"]["bias"])
    return _linear(p["output_dense"], F.gelu(_linear(p["intermediate_dense"], x)))


def _encoder_layer_post_ln(p, x, num_heads, bias=None):
    x = _layer_norm(p["layer_norm"], x + _attention(p["attention"], x,
                                                    num_heads, bias))
    return _layer_norm(p["final_layer_norm"],
                       x + _feed_forward(p["feed_forward"], x))


def _encoder_layer_pre_ln(p, x, num_heads, bias=None):
    x = x + _attention(p["attention"], _layer_norm(p["layer_norm"], x),
                       num_heads, bias)
    return x + _feed_forward(p["feed_forward"],
                             _layer_norm(p["final_layer_norm"], x))


class EncoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor
    hidden_states: tuple        # (num_layers + 1) entries, HF layout


def encoder(params, x, cfg: Wav2Vec2Config, collect_hidden: bool = False,
            attention_mask=None) -> EncoderOutput:
    """Transformer encoder over projected features (B, T, H).

    ``attention_mask`` (B, T), 1 = real frame: masked frames are zeroed
    before the positional conv and get an additive key bias of -1e9 in
    every attention (HF Wav2Vec2Encoder)."""
    bias = None
    if attention_mask is not None:
        x = x * attention_mask.to(x.dtype)[..., None]
        bias = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
    x = x + _pos_conv_embed(params["pos_conv_embed"], x, cfg)
    hidden = []
    if cfg.do_stable_layer_norm:
        for i in range(cfg.num_hidden_layers):
            if collect_hidden:
                hidden.append(x)
            x = _encoder_layer_pre_ln(params["layers"][str(i)], x,
                                      cfg.num_attention_heads, bias)
        x = _layer_norm(params["layer_norm"], x)
    else:
        x = _layer_norm(params["layer_norm"], x)
        for i in range(cfg.num_hidden_layers):
            if collect_hidden:
                hidden.append(x)
            x = _encoder_layer_post_ln(params["layers"][str(i)], x,
                                       cfg.num_attention_heads, bias)
    if collect_hidden:
        hidden.append(x)
    return EncoderOutput(x, tuple(hidden))


def _project(params, feats):
    h = _layer_norm(params["feature_projection"]["layer_norm"], feats)
    return _linear(params["feature_projection"]["projection"], h)


def feat_extract_output_length(n: int, cfg: Wav2Vec2Config) -> int:
    """Conv-stack output length for ``n`` input samples (HF
    _get_feat_extract_output_lengths: L -> (L - k) // s + 1 per layer)."""
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


def feature_extract(params, wave, seq_len: int, cfg: Wav2Vec2Config):
    """Split stage 1 of the reference Wav2VecModel: conv features linearly
    resampled to ``seq_len`` video frames -> (B, seq_len, conv_dim[-1])."""
    feats = feature_extractor(params["feature_extractor"], wave, cfg)
    return linear_interpolate_time(feats, seq_len)


def encode(params, extract_features_out, cfg: Wav2Vec2Config,
           collect_hidden: bool = True) -> EncoderOutput:
    """Split stage 2: feature projection and transformer encoder over
    already-extracted features."""
    return encoder(params["encoder"], _project(params, extract_features_out),
                   cfg, collect_hidden=collect_hidden)


def wav2vec2_frame_features(params, wave, seq_len: int, cfg: Wav2Vec2Config,
                            collect_hidden: bool = True) -> EncoderOutput:
    """The reference Wav2VecModel.forward: ``feature_extract`` then
    ``encode``."""
    return encode(params, feature_extract(params, wave, seq_len, cfg), cfg,
                  collect_hidden=collect_hidden)


def feature_vector_attention_mask(attention_mask, t_conv: int,
                                  cfg: Wav2Vec2Config):
    """A (B, N) sample mask on the (B, T_conv) conv frame grid: frames up to
    the conv output length of each item's sample count are real (HF
    _get_feature_vector_attention_mask)."""
    lengths = attention_mask.long().sum(dim=-1)
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    frame = torch.arange(t_conv, device=attention_mask.device)[None, :]
    return (frame < lengths[:, None]).int()


def wav2vec2_standard(params, wave, cfg: Wav2Vec2Config,
                      attention_mask=None):
    """The standard HF Wav2Vec2Model forward (no frame resampling) -> last
    hidden state (B, T_conv, H); the SER tower's.  ``attention_mask``
    (B, N) samples, 1 = real, goes onto the conv frame grid and into the
    encoder."""
    feats = feature_extractor(params["feature_extractor"], wave, cfg)
    frame_mask = None
    if attention_mask is not None:
        frame_mask = feature_vector_attention_mask(attention_mask,
                                                   feats.shape[1], cfg)
    return encoder(params["encoder"], _project(params, feats), cfg,
                   attention_mask=frame_mask).last_hidden_state


def ser_logits(params, wave, cfg: Wav2Vec2Config, attention_mask=None):
    """Speech-emotion classifier: ``wav2vec2_standard``, mean pool over
    time, dense/tanh/out_proj.  The mask shapes the encoder pass only: the
    pool stays unmasked, as in the reference (wav2vec2_ser.py:57-86)."""
    h = wav2vec2_standard(params, wave, cfg, attention_mask)
    x = torch.tanh(_linear(params["classifier"]["dense"], h.mean(dim=1)))
    return _linear(params["classifier"]["out_proj"], x)


def predict_emotion(params, wave, cfg: Wav2Vec2Config, attention_mask=None):
    """Softmax emotion scores (B, num_labels) (reference FLOAT.py:396-401)."""
    return torch.softmax(ser_logits(params, wave, cfg,
                                    attention_mask).float(), dim=-1)
