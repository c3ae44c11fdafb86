"""FloatPipeline — the stage API, one-shot ``generate`` and the
host-delivery entry points on one torch device (twin of
``float_tpu.runtime.pipeline``).

    encode_image : (1, 3, S, S) in [-1, 1] -> s_r, r_s_lambda, feats, r_s
    encode_audio : (1, N) wave              -> wa (1, T, dim_w)
    emotion      : wave | label             -> we (1, 1, E)
    sample       : r_s + wa + we + noise    -> r_d motion latents (1, T, dim_w)
    decode       : s_r + feats + r_d        -> (T, S, S, 3) frames in [0, 1]

    decode_to_host  : frames into host memory, chunk by chunk
    generate_stream : frames yielded chunk by chunk while sampling goes on
    generate_batch  : several clips (ragged audio too) -> numpy clips
    warmup          : the serving paths run once before the first request

The pipeline runs on ``device`` ("cuda" unless the caller passes another);
without a CUDA device, ``device="cpu"`` must be given.  Weights load into
:class:`~float_torch.models.init.ParamTree` modules with one
``load_state_dict(strict=True)``; the synthesis weights are cast to
``cfg.compute_dtype`` once, at construction, and the sampler runs in
``cfg.sampler_dtype``.  Everything runs under ``torch.inference_mode``.

Constructing a pipeline sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False, so float32 matmuls and
convolutions on a CUDA device run in full float32, as the reference does.
"""
from __future__ import annotations

import copy
import math
import time
from typing import NamedTuple, Optional

import torch

from ..config import (EMOTION_LABELS, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
                      FloatConfig, Wav2Vec2Config)
from ..models.audio_encoder import encode_audio as _encode_audio
from ..models.encoder import encode_image as _encode_image
from ..models.fmt import infer_cfg_mode
from ..models.init import empty_pipeline, init_pipeline, params_to_state_dict
from ..models.synthesis import direction
from ..models.wav2vec2 import predict_emotion as _predict_emotion
from .decode import (decode_clips_to_host, decode_latents,
                     decode_latents_stream, decode_latents_to_host,
                     stream_chunk_count)
from .sampling import sample_motion_chunks, sample_motion_latents


def audio_num_frames(n_samples: int, cfg: FloatConfig) -> int:
    """T = ceil(N * fps / sr) (reference FLOAT.py:270)."""
    return math.ceil(n_samples * cfg.fps / cfg.sampling_rate)


def one_hot_emotion(label: str, dim_e: int = 7, device=None) -> torch.Tensor:
    """(1, 1, E) one-hot for a named emotion (reference FLOAT.py:200)."""
    we = torch.zeros((1, 1, dim_e), dtype=torch.float32, device=device)
    we[0, 0, EMOTION_LABELS.index(label.lower())] = 1.0
    return we


def _stage_cb(progress, stage: str):
    """Adapt a ``progress(stage, i, n)`` callback to the decode loops'
    (i, n) frame_callback; None passes through."""
    if progress is None:
        return None
    return lambda i, n: progress(stage, i + 1, n)


def _report(progress, stage: str, i: int = 1, n: int = 1):
    if progress is not None:
        progress(stage, i, n)


def _checked_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the pipeline runs on a CUDA device unless told "
                           "otherwise, and none is available; pass "
                           "device='cpu' to run on the CPU")
    return device


class SourceLatents(NamedTuple):
    """A pre-encoded source image, reusable across clips of one speaker
    (the reference's separate image-encode node implies this reuse,
    nodes_adv.py FloatImageEncode).  Made by ``FloatPipeline.prepare_source``
    and taken by ``generate`` / ``generate_stream`` as ``source=``, which
    skips the per-clip encoder forward."""
    s_r: torch.Tensor
    r_s_lambda: torch.Tensor
    feats: list
    r_s: torch.Tensor


class FloatPipeline:
    """End-to-end talking-portrait generation on one device.

    params: {'encoder', 'synthesis', 'audio_encoder': {'wav2vec2',
    'audio_projection'}, 'emotion', 'fmt'} with array leaves — the layout
    of ``models.init.init_pipeline`` and of ``float_tpu``'s params.
    ``device``: "cuda" by default; "cpu" runs the plain PyTorch versions
    of the kernels and must be asked for.
    """

    def __init__(self, params: dict, cfg: FloatConfig = FloatConfig(),
                 w2v_cfg: Wav2Vec2Config = WAV2VEC2_BASE,
                 ser_cfg: Wav2Vec2Config = WAV2VEC2_LARGE_SER,
                 device="cuda"):
        self.device = _checked_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg.validate()
        self.w2v_cfg = w2v_cfg
        self.ser_cfg = ser_cfg
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

    def prepare_source(self, img) -> SourceLatents:
        """Encode a source image once for reuse across clips: pass the
        result as ``source=`` to generate / generate_stream."""
        return SourceLatents(*self.encode_image(img))

    def _resolve_source(self, img, source, progress) -> SourceLatents:
        if source is not None:
            # no encoder forward ran: report the reuse as its own stage
            _report(progress, "reuse_source")
            return source
        if img is None:
            raise ValueError("provide img or source=")
        out = self.prepare_source(img)
        _report(progress, "encode_image")
        return out

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

    def _sampler_args(self, r_s, wa, we, *, seed=None, a_cfg_scale=None,
                      e_cfg_scale=None, r_cfg_scale=None, nfe=None,
                      ode_method=None, noise=None) -> dict:
        """Keywords of ``sampling.sample_motion_chunks`` /
        ``sample_motion_latents``: conditions in ``cfg.sampler_dtype``,
        noise from a ``torch.Generator`` on the pipeline's device seeded
        with ``seed`` (default cfg.seed) unless ``noise`` is given."""
        cfg = self.cfg
        a_s = cfg.a_cfg_scale if a_cfg_scale is None else a_cfg_scale
        e_s = cfg.e_cfg_scale if e_cfg_scale is None else e_cfg_scale
        r_sc = cfg.r_cfg_scale if r_cfg_scale is None else r_cfg_scale
        gen = None
        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed if seed is None else seed)
        sdt = self.sampler_dtype
        return dict(
            fmt_params=self.params["fmt"], r_s=r_s.to(sdt), wa=wa.to(sdt),
            we=we.to(sdt), cfg=cfg, a_cfg_scale=a_s, e_cfg_scale=e_s,
            r_cfg_scale=r_sc, nfe=cfg.nfe if nfe is None else nfe,
            ode_method=cfg.ode_method if ode_method is None else ode_method,
            cfg_mode=infer_cfg_mode(a_s, r_sc, e_s, cfg.include_r_cfg),
            generator=gen, noise=noise)

    @torch.inference_mode()
    def sample(self, r_s, wa, we, *, seed: Optional[int] = None,
               a_cfg_scale=None, e_cfg_scale=None, r_cfg_scale=None,
               nfe=None, ode_method=None, noise=None) -> torch.Tensor:
        """r_d (B, T, dim_w) f32 by chunked CFG-ODE sampling in
        ``cfg.sampler_dtype``.  Chunk noise comes from a ``torch.Generator``
        on the pipeline's device seeded with ``seed`` (default cfg.seed),
        drawn chunk after chunk, or from ``noise`` (n_chunks, B, clip,
        dim_w)."""
        return sample_motion_latents(**self._sampler_args(
            r_s, wa, we, seed=seed, a_cfg_scale=a_cfg_scale,
            e_cfg_scale=e_cfg_scale, r_cfg_scale=r_cfg_scale, nfe=nfe,
            ode_method=ode_method, noise=noise)).float()

    def _decode_args(self) -> dict:
        return dict(size=self.cfg.input_size,
                    decode_batch=self.cfg.decode_batch,
                    compute_dtype=self.compute_dtype)

    @torch.inference_mode()
    def decode(self, s_r, feats, r_d, progress=None) -> torch.Tensor:
        """(1, dim_w) + feats + (1|T, T, dim_w) -> (T, S, S, 3) in [0, 1] on
        the device.  ``progress(stage, i, n)`` fires as each chunk is
        dispatched."""
        if r_d.ndim == 3:
            r_d = r_d[0]
        return decode_latents(self.syn_cast, s_r, feats, r_d,
                              frame_callback=_stage_cb(progress, "decode"),
                              **self._decode_args())

    def decode_to_host(self, s_r, feats, r_d, uint8_transfer: bool = True,
                       progress=None):
        """Decode into host memory as float32 numpy (T, S, S, 3) in [0, 1],
        uint8 on the wire by default; each chunk's copy overlaps the next
        chunk's compute — for long clips.  ``progress(stage, i, n)`` fires
        as each chunk's bytes arrive on the host."""
        if r_d.ndim == 3:
            r_d = r_d[0]
        return decode_latents_to_host(
            self.syn_cast, s_r, feats, r_d, uint8_transfer=uint8_transfer,
            frame_callback=_stage_cb(progress, "decode"),
            **self._decode_args())

    # ------------------------------------------------------------------
    # one-shot generation
    # ------------------------------------------------------------------

    def _conditions(self, wave, emotion, fps, progress):
        """(T, wa, we) of one clip's audio, reporting both stages."""
        cfg = self.cfg if fps is None else self.cfg.replace(fps=fps)
        t_frames = audio_num_frames(wave.shape[-1], cfg)
        wa = self.encode_audio(wave, t_frames)
        _report(progress, "encode_audio")
        we = self.emotion_latent(wave, emotion)
        _report(progress, "emotion")
        return t_frames, wa, we

    @torch.inference_mode()
    def generate(self, img, wave, *, emotion: str = "none",
                 seed: Optional[int] = None, a_cfg_scale=None,
                 e_cfg_scale=None, r_cfg_scale=None, nfe=None,
                 ode_method=None, progress=None,
                 source: Optional[SourceLatents] = None,
                 fps: Optional[float] = None) -> torch.Tensor:
        """(1, 3, S, S) image + (1, N) audio -> (T, S, S, 3) frames in
        [0, 1] on the device (reference FLOAT.inference, FLOAT.py:255-298).

        ``progress(stage, i, n)`` reports the encode / audio / emotion /
        sample stages and each decode chunk.  ``source=`` (from
        ``prepare_source``) reuses a pre-encoded image; ``img`` may then be
        None.  ``fps`` retimes the output for this clip; the sampler's
        chunk span stays on the pipeline config, as in the reference."""
        wave = self._tensor(wave)
        s_r, _lam, feats, r_s = self._resolve_source(img, source, progress)
        _t, wa, we = self._conditions(wave, emotion, fps, progress)
        r_d = self.sample(r_s, wa, we, seed=seed, a_cfg_scale=a_cfg_scale,
                          e_cfg_scale=e_cfg_scale, r_cfg_scale=r_cfg_scale,
                          nfe=nfe, ode_method=ode_method)
        _report(progress, "sample")
        return self.decode(s_r, feats, r_d, progress=progress)

    @torch.inference_mode()
    def generate_stream(self, img, wave, *, emotion: str = "none",
                        seed: Optional[int] = None, a_cfg_scale=None,
                        e_cfg_scale=None, r_cfg_scale=None, nfe=None,
                        ode_method=None, uint8_transfer: bool = True,
                        progress=None, source: Optional[SourceLatents] = None,
                        fps: Optional[float] = None, first_chunk: int = 0,
                        wire: str = "f32"):
        """Streaming generation: yields (start_frame, frames) numpy as soon
        as each decode chunk reaches the host.

        ``wire``: "f32" yields float32 (k, S, S, 3) in [0, 1] (uint8 on the
        wire when ``uint8_transfer``); "u8" yields uint8 RGB; "yuv420"
        yields planar 4:2:0 uint8 (k, S·3/2, S), half the u8 bytes
        (invert with ``ops.yuv420.i420_to_rgb_u8``).  ``uint8_transfer``
        matters only for "f32"; it is kept beside ``wire`` for parity with
        float_tpu's signature.  ``first_chunk`` > 0 makes the first decode
        chunk that many frames (rounded up to a multiple of 4) so the first
        frames arrive sooner; ``progress("decode", i, n)`` counts that
        ramp in ``n``.

        The sampler runs chunk by chunk, interleaved with decode dispatch,
        drawing the same noise from the same generator in the same order
        as ``sample``: the stream's frames are ``generate``'s."""
        cfg = self.cfg
        wave = self._tensor(wave)
        s_r, _lam, feats, r_s = self._resolve_source(img, source, progress)
        t_frames, wa, we = self._conditions(wave, emotion, fps, progress)
        n_chunks = math.ceil(t_frames / cfg.num_frames_for_clip)
        chunks = sample_motion_chunks(**self._sampler_args(
            r_s, wa, we, seed=seed, a_cfg_scale=a_cfg_scale,
            e_cfg_scale=e_cfg_scale, r_cfg_scale=r_cfg_scale, nfe=nfe,
            ode_method=ode_method))

        def latent_pieces():
            done = 0
            for c, sample_t in enumerate(chunks):
                take = min(cfg.num_frames_for_clip, t_frames - done)
                done += take
                _report(progress, "sample", c + 1, n_chunks)
                yield sample_t[0, :take].float()

        n_dchunks = stream_chunk_count(t_frames, cfg.decode_batch,
                                       first_chunk)
        cb = None
        if progress is not None:
            cb = lambda i, n: progress("decode", i + 1, n_dchunks)  # noqa: E731
        yield from decode_latents_stream(
            self.syn_cast, s_r, feats, latent_pieces(),
            uint8_transfer=uint8_transfer, frame_callback=cb,
            first_chunk=first_chunk, emit=wire, **self._decode_args())

    def warmup(self, seconds: float = 2.0, first_chunk: int = 8) -> float:
        """Run the serving paths once before the first request: on the
        card this builds both kernel libraries (``kernels.build.build_all``)
        and lets cuDNN pick its algorithms for the full and first-chunk
        decode shapes.  One ``generate`` and one ``generate_stream`` per
        serving wire ("u8" raw, "yuv420" JPEG delivery) on seeded inputs of
        ``seconds`` of audio, closed by a synchronize.  Returns the wall
        seconds spent.  ``cli serve --warm`` calls this before binding the
        port."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ..kernels.build import build_all
            build_all()
        cfg = self.cfg
        gen = torch.Generator().manual_seed(0)
        img = 0.1 * torch.randn((1, 3, cfg.input_size, cfg.input_size),
                                generator=gen)
        wave = 0.05 * torch.randn((1, int(seconds * cfg.sampling_rate)),
                                  generator=gen)
        self.generate(img, wave, emotion="none", seed=cfg.seed)
        for wire in ("u8", "yuv420"):
            for _chunk in self.generate_stream(img, wave, emotion="none",
                                               seed=cfg.seed,
                                               first_chunk=first_chunk,
                                               wire=wire):
                pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    @torch.inference_mode()
    def generate_batch(self, imgs, waves, *, emotion: str = "none",
                       seeds=None, a_cfg_scale=None, e_cfg_scale=None,
                       r_cfg_scale=None, nfe=None, ode_method=None,
                       progress=None) -> list:
        """B clips: one batched image encode, audio encoded per length
        group, each clip sampled with its own seed, and all clips' decode
        chunks in one dispatch stream (``decode.decode_clips_to_host``).

        imgs (B, 3, S, S); waves (B, N) of equal length, or a list of B 1-D
        waves of differing lengths (a ragged batch).  Ragged clips are not
        zero-padded to one length, since padding would change the wav2vec2
        attention and so the features of the real frames; a ragged list of
        equal lengths is one batch.  ``seeds``: per-clip noise
        seeds (default cfg.seed + i, the reference's per-item seed + i,
        nodes.py:189-211).  Returns a list of B (T_i, S, S, 3) float32
        numpy arrays in [0, 1] (uint8 on the wire), each equal to the
        clip's own ``generate`` up to that quantisation."""
        cfg = self.cfg
        imgs = self._tensor(imgs)
        bsz = imgs.shape[0]
        if isinstance(waves, (list, tuple)):
            waves = [self._tensor(w).reshape(-1) for w in waves]
        else:
            waves = list(self._tensor(waves))
        if len(waves) != bsz:
            raise ValueError(f"{bsz} images but {len(waves)} waves")
        if seeds is None:
            seeds = [cfg.seed + i for i in range(bsz)]

        s_r, _lam, feats, r_s = self.encode_image(imgs)
        _report(progress, "encode_image")

        # the audio stages run once per length group, batched (every op is
        # independent across the batch), scattered back to request order
        groups: dict = {}
        for i, w in enumerate(waves):
            groups.setdefault(int(w.shape[-1]), []).append(i)
        wa_i = [None] * bsz
        we_i = [None] * bsz
        for n, idxs in sorted(groups.items()):
            wv = torch.stack([waves[i] for i in idxs])
            wa_g = self.encode_audio(wv, audio_num_frames(n, cfg))
            we_g = self.emotion_latent(wv, emotion)
            for k, i in enumerate(idxs):
                wa_i[i] = wa_g[k:k + 1]
                # a named emotion's one-hot has batch 1
                we_i[i] = we_g[min(k, we_g.shape[0] - 1)][None]
        _report(progress, "encode_audio")
        _report(progress, "emotion")

        r_ds = [self.sample(r_s[i:i + 1], wa_i[i], we_i[i], seed=seeds[i],
                            a_cfg_scale=a_cfg_scale, e_cfg_scale=e_cfg_scale,
                            r_cfg_scale=r_cfg_scale, nfe=nfe,
                            ode_method=ode_method)[0]
                for i in range(bsz)]
        _report(progress, "sample")

        clips = [(s_r[i:i + 1], [f[i:i + 1] for f in feats], r_ds[i])
                 for i in range(bsz)]
        return decode_clips_to_host(
            self.syn_cast, clips, frame_callback=_stage_cb(progress, "decode"),
            **self._decode_args())


def build_synthetic_pipeline(cfg: FloatConfig = FloatConfig(),
                             w2v_cfg: Wav2Vec2Config = WAV2VEC2_BASE,
                             ser_cfg: Wav2Vec2Config = WAV2VEC2_LARGE_SER,
                             seed: int = 0, device="cuda") -> FloatPipeline:
    """Pipeline with seeded random weights, bit-identical to float_tpu's
    ``build_synthetic_pipeline`` at the same configs and seed; on the CUDA
    device unless ``device`` says otherwise."""
    device = _checked_device(device)
    return FloatPipeline(init_pipeline(cfg, w2v_cfg, ser_cfg, seed), cfg,
                         w2v_cfg, ser_cfg, device=device)
