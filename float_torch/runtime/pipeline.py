"""FloatPipeline — the stage API and one-shot ``generate`` on one torch
device (twin of ``float_tpu.runtime.pipeline``).

    encode_image : (1, 3, S, S) in [-1, 1] -> s_r, r_s_lambda, feats, r_s
    encode_audio : (1, N) wave              -> wa (1, T, dim_w)
    emotion      : wave | label             -> we (1, 1, E)
    sample       : r_s + wa + we + noise    -> r_d motion latents (1, T, dim_w)
    decode       : s_r + feats + r_d        -> (T, S, S, 3) frames in [0, 1]

Weights load into :class:`~float_torch.models.init.ParamTree` modules with
one ``load_state_dict(strict=True)``; the synthesis weights are cast to
``cfg.compute_dtype`` once, at construction, and the sampler runs in
``cfg.sampler_dtype``.  Everything runs under ``torch.inference_mode``.

Constructing a pipeline sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False, so float32 matmuls and
convolutions on a CUDA device run in full float32, as the reference does.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch

from ..config import (EMOTION_LABELS, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
                      FloatConfig, Wav2Vec2Config)
from ..models.audio_encoder import encode_audio as _encode_audio
from ..models.encoder import encode_image as _encode_image
from ..models.fmt import infer_cfg_mode
from ..models.init import empty_pipeline, init_pipeline, params_to_state_dict
from ..models.synthesis import direction
from ..models.wav2vec2 import predict_emotion as _predict_emotion
from .decode import decode_latents
from .sampling import sample_motion_latents


def audio_num_frames(n_samples: int, cfg: FloatConfig) -> int:
    """T = ceil(N * fps / sr) (reference FLOAT.py:270)."""
    return math.ceil(n_samples * cfg.fps / cfg.sampling_rate)


def one_hot_emotion(label: str, dim_e: int = 7, device=None) -> torch.Tensor:
    """(1, 1, E) one-hot for a named emotion (reference FLOAT.py:200)."""
    we = torch.zeros((1, 1, dim_e), dtype=torch.float32, device=device)
    we[0, 0, EMOTION_LABELS.index(label.lower())] = 1.0
    return we


class FloatPipeline:
    """End-to-end talking-portrait generation on one device.

    params: {'encoder', 'synthesis', 'audio_encoder': {'wav2vec2',
    'audio_projection'}, 'emotion', 'fmt'} with array leaves — the layout
    of ``models.init.init_pipeline`` and of ``float_tpu``'s params.
    """

    def __init__(self, params: dict, cfg: FloatConfig = FloatConfig(),
                 w2v_cfg: Wav2Vec2Config = WAV2VEC2_BASE,
                 ser_cfg: Wav2Vec2Config = WAV2VEC2_LARGE_SER,
                 device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg.validate()
        self.w2v_cfg = w2v_cfg
        self.ser_cfg = ser_cfg
        self.device = torch.device(device)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.sampler_dtype = getattr(torch, cfg.sampler_dtype)
        self.params = empty_pipeline(cfg, w2v_cfg, ser_cfg, self.device)
        self.params.load_state_dict(params_to_state_dict(params), strict=True)
        self.syn_cast = copy.deepcopy(self.params["synthesis"]).to(
            self.compute_dtype)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # stage API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, img):
        """img (B, 3, S, S) in [-1, 1] -> (s_r, r_s_lambda, feats, r_s)."""
        s_r, lam, feats = _encode_image(self.params["encoder"],
                                        self._tensor(img), self.cfg.input_size)
        return s_r, lam, feats, direction(self.params["synthesis"]["direction"],
                                          lam)

    @torch.inference_mode()
    def encode_audio(self, wave, seq_len: int) -> torch.Tensor:
        """wave (B, N) normalised -> wa (B, seq_len, dim_w)."""
        return _encode_audio(self.params["audio_encoder"], self._tensor(wave),
                             seq_len, self.cfg, self.w2v_cfg)

    @torch.inference_mode()
    def predict_emotion(self, wave) -> torch.Tensor:
        """wave (B, N) -> softmax scores (B, E).  Clips longer than
        ``cfg.ser_max_sec`` are predicted over fixed windows and the scores
        averaged, weighted by window length (a sub-0.1 s tail is dropped)."""
        wave = self._tensor(wave)
        cfg = self.cfg
        max_n = int(cfg.ser_max_sec * cfg.sampling_rate)
        n = wave.shape[-1]
        if n <= max_n:
            return _predict_emotion(self.params["emotion"], wave, self.ser_cfg)
        scores, weights = [], []
        for lo in range(0, n, max_n):
            w = wave[:, lo:lo + max_n]
            if w.shape[-1] < 1600:
                break
            scores.append(_predict_emotion(self.params["emotion"], w,
                                           self.ser_cfg))
            weights.append(w.shape[-1])
        tot = float(sum(weights))
        out = scores[0] * (weights[0] / tot)
        for s, wt in zip(scores[1:], weights[1:]):
            out = out + s * (wt / tot)
        return out

    def emotion_latent(self, wave, emotion: str = "none") -> torch.Tensor:
        """we (B, 1, E): one-hot for a named emotion, else predicted from
        the audio (reference FLOAT.py:196-200)."""
        if emotion and emotion.lower() in EMOTION_LABELS:
            return one_hot_emotion(emotion, self.cfg.dim_e, self.device)
        if wave is None:
            raise ValueError("emotion='none' requires audio")
        return self.predict_emotion(wave)[:, None, :]

    @torch.inference_mode()
    def sample(self, r_s, wa, we, *, seed: Optional[int] = None,
               a_cfg_scale=None, e_cfg_scale=None, r_cfg_scale=None,
               nfe=None, ode_method=None, noise=None) -> torch.Tensor:
        """r_d (B, T, dim_w) f32 by chunked CFG-ODE sampling in
        ``cfg.sampler_dtype``.  Chunk noise comes from a ``torch.Generator``
        on the pipeline's device seeded with ``seed`` (default cfg.seed),
        or from ``noise`` (n_chunks, B, clip, dim_w)."""
        cfg = self.cfg
        a_s = cfg.a_cfg_scale if a_cfg_scale is None else a_cfg_scale
        e_s = cfg.e_cfg_scale if e_cfg_scale is None else e_cfg_scale
        r_sc = cfg.r_cfg_scale if r_cfg_scale is None else r_cfg_scale
        gen = None
        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed if seed is None else seed)
        sdt = self.sampler_dtype
        r_d = sample_motion_latents(
            self.params["fmt"], r_s.to(sdt), wa.to(sdt), we.to(sdt), cfg=cfg,
            a_cfg_scale=a_s, e_cfg_scale=e_s, r_cfg_scale=r_sc,
            nfe=cfg.nfe if nfe is None else nfe,
            ode_method=cfg.ode_method if ode_method is None else ode_method,
            cfg_mode=infer_cfg_mode(a_s, r_sc, e_s, cfg.include_r_cfg),
            generator=gen, noise=noise)
        return r_d.float()

    @torch.inference_mode()
    def decode(self, s_r, feats, r_d) -> torch.Tensor:
        """(1, dim_w) + feats + (1|T, T, dim_w) -> (T, S, S, 3) in [0, 1]."""
        if r_d.ndim == 3:
            r_d = r_d[0]
        return decode_latents(self.syn_cast, s_r, feats, r_d,
                              size=self.cfg.input_size,
                              decode_batch=self.cfg.decode_batch,
                              compute_dtype=self.compute_dtype)

    @torch.inference_mode()
    def generate(self, img, wave, *, emotion: str = "none",
                 seed: Optional[int] = None, a_cfg_scale=None,
                 e_cfg_scale=None, r_cfg_scale=None, nfe=None,
                 ode_method=None, fps: Optional[float] = None) -> torch.Tensor:
        """(1, 3, S, S) image + (1, N) audio -> (T, S, S, 3) frames in
        [0, 1] (reference FLOAT.inference, FLOAT.py:255-298).  ``fps``
        retimes the output for this clip; the sampler's chunk span stays
        on the pipeline config, as in the reference."""
        wave = self._tensor(wave)
        t_frames = audio_num_frames(
            wave.shape[-1],
            self.cfg if fps is None else self.cfg.replace(fps=fps))
        s_r, _lam, feats, r_s = self.encode_image(img)
        wa = self.encode_audio(wave, t_frames)
        we = self.emotion_latent(wave, emotion)
        r_d = self.sample(r_s, wa, we, seed=seed, a_cfg_scale=a_cfg_scale,
                          e_cfg_scale=e_cfg_scale, r_cfg_scale=r_cfg_scale,
                          nfe=nfe, ode_method=ode_method)
        return self.decode(s_r, feats, r_d)


def build_synthetic_pipeline(cfg: FloatConfig = FloatConfig(),
                             w2v_cfg: Wav2Vec2Config = WAV2VEC2_BASE,
                             ser_cfg: Wav2Vec2Config = WAV2VEC2_LARGE_SER,
                             seed: int = 0, device="cpu") -> FloatPipeline:
    """Pipeline with seeded random weights, bit-identical to float_tpu's
    ``build_synthetic_pipeline`` at the same configs and seed."""
    return FloatPipeline(init_pipeline(cfg, w2v_cfg, ser_cfg, seed), cfg,
                         w2v_cfg, ser_cfg, device=device)
