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


def _attention(p, x, num_heads: int, bias=None):
    b, t, c = x.shape
    hd = c // num_heads
    q = _linear(p["q_proj"], x) * (hd ** -0.5)
    k = _linear(p["k_proj"], x)
    v = _linear(p["v_proj"], x)
    q, k, v = (a.reshape(b, t, num_heads, hd).transpose(1, 2)
               for a in (q, k, v))
    logits = (q @ k.transpose(-1, -2)).float()
    if bias is not None:
        logits = logits + bias
    att = torch.softmax(logits, dim=-1).to(x.dtype)
    out = (att @ v).transpose(1, 2).reshape(b, t, c)
    return _linear(p["out_proj"], out)


def _feed_forward(p, x):
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


def wav2vec2_frame_features(params, wave, seq_len: int, cfg: Wav2Vec2Config,
                            collect_hidden: bool = True) -> EncoderOutput:
    """The reference Wav2VecModel.forward: conv features linearly resampled
    to ``seq_len`` video frames, then projected and encoded."""
    feats = feature_extractor(params["feature_extractor"], wave, cfg)
    feats = linear_interpolate_time(feats, seq_len)
    return encoder(params["encoder"], _project(params, feats), cfg,
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


def ser_logits(params, wave, cfg: Wav2Vec2Config, attention_mask=None):
    """Speech-emotion classifier: standard wav2vec2 forward (no frame
    resampling), mean pool over time, dense/tanh/out_proj.
    ``attention_mask`` (B, N) samples, 1 = real, shapes the encoder pass
    only: the pool stays unmasked, as in the reference
    (wav2vec2_ser.py:57-86)."""
    feats = feature_extractor(params["feature_extractor"], wave, cfg)
    frame_mask = None
    if attention_mask is not None:
        frame_mask = feature_vector_attention_mask(attention_mask,
                                                   feats.shape[1], cfg)
    h = encoder(params["encoder"], _project(params, feats), cfg,
                attention_mask=frame_mask).last_hidden_state
    x = torch.tanh(_linear(params["classifier"]["dense"], h.mean(dim=1)))
    return _linear(params["classifier"]["out_proj"], x)


def predict_emotion(params, wave, cfg: Wav2Vec2Config, attention_mask=None):
    """Softmax emotion scores (B, num_labels) (reference FLOAT.py:396-401)."""
    return torch.softmax(ser_logits(params, wave, cfg,
                                    attention_mask).float(), dim=-1)
