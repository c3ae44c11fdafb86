"""The FLOAT node operations as functions (twin of ``float_tpu.api.nodes``).

Same operation names, parameter names and input/output contracts as the
reference's ComfyUI nodes, as plain functions over numpy arrays (images,
audio) and torch tensors (latents, on the model's device), so every
example-workflow topology can be called from Python and by the graph
executor (``api/comfy.py``).

Tiers:
- Regular  : load_float_models, float_process
- Advanced : float_image_face_align, float_advanced_parameters,
             float_encode_image_to_latents, float_get_identity_reference,
             float_encode_audio_to_wa, float_encode_emotion_to_we,
             float_sample_motion_sequence, float_decode_latents_to_images
- Very Adv : load_wav2vec_model, load_audio_projection, load_emotion_model,
             load_float_encoder, load_float_synthesis, load_fmt_model,
             audio_preprocess_and_feature_extract, apply_audio_projection,
             extract_emotion, extract_emotion_dynamic, apply_float_encoder,
             get_identity_reference_va, sample_motion_sequence_va,
             apply_float_synthesis

Models run on the card unless the caller asks for the CPU:
``load_float_models(target_device=...)`` takes "cpu" for the CPU and any
other value (the reference's "cuda", a bundled workflow's "tpu") for the
card; the Very Advanced loaders take ``device=`` ("cuda" by default); the
apply nodes run where their model lives.  Noise comes from a
``torch.Generator`` seeded with the node's seed, so the port and
``float_tpu`` (JAX's PRNG) draw different noise for one seed.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.features import (DEFAULT_FE, extract_features,
                              load_preprocessor_config, normalize_waveform)
from ..audio.resample import comfy_audio_to_mono_16k
from ..config import (EMOTION_LABELS, WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
                      FloatConfig, Wav2Vec2Config, apply_adv_options)
from ..image.face_align import face_align_crop
from ..image.rgba import image_to_uint8
from ..image.transform import comfy_image_to_model_input
from ..io import checkpoint as ckpt
from ..io.hf import config_from_json, load_wav2vec2_dir
from ..models.audio_encoder import audio_projection as _audio_projection_fn
from ..models.audio_encoder import pad_wave_to_frames, stacked_features
from ..models.encoder import encode_image as _encode_image_fn
from ..models.init import tree_to_module
from ..models.synthesis import direction as _direction_fn
from ..models.wav2vec2 import predict_emotion as _predict_emotion
from ..ops import nearest_interpolate_time
from ..runtime.decode import decode_clips_to_host
from ..runtime.pipeline import (FloatPipeline, _checked_device, _stage_cb,
                                audio_num_frames, build_synthetic_pipeline,
                                one_hot_emotion)
from ..runtime.sampling import sample_motion_latents
from .types import (AppearancePipe, AudioProjectionLayer, BBox,
                    EmotionModelPipe, EncoderModel, FloatPipe, FMTModel,
                    SynthesisModel, Wav2VecPipe)

logger = logging.getLogger("float_torch.api")

AudioLike = Union[Dict[str, Any], np.ndarray]


def node_device(target_device: str) -> torch.device:
    """A node's device widget -> torch device: "cpu" is the CPU, any other
    value ("cuda", "tpu", ...) the card, which must be present."""
    return _checked_device("cpu" if str(target_device).lower() == "cpu"
                           else "cuda")


def _audio_to_waves(audio: AudioLike, sr: int = 16000) -> List[np.ndarray]:
    """AUDIO dict (B,C,N) or array -> list of mono 16 kHz float32 waves."""
    if isinstance(audio, dict):
        wf = np.asarray(audio["waveform"])
        if wf.ndim == 2:
            wf = wf[None]
        return [comfy_audio_to_mono_16k(
            {"waveform": wf[i:i + 1], "sample_rate": audio["sample_rate"]}, sr)
            for i in range(wf.shape[0])]
    arr = np.asarray(audio, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    return [arr[i] for i in range(arr.shape[0])]


def _image_to_model(img: np.ndarray, device) -> torch.Tensor:
    """IMAGE (B, S, S, 3) [0, 1] -> (B, 3, S, S) [-1, 1] on ``device``."""
    x = np.transpose(img, (0, 3, 1, 2)) * 2.0 - 1.0
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ===========================================================================
# Regular tier
# ===========================================================================

def _resolve_checkpoint_path(model: str, models_root: str) -> str:
    """Model-store discovery: an existing path wins; otherwise a bare file
    name resolves under <models_root>/float/ (the reference's convention,
    nodes.py:62-63: ckpt path = folder_paths.models_dir/float/<model>)."""
    if os.path.exists(model):
        return model
    if os.sep not in model and models_root:
        return os.path.join(models_root, "float", model)
    return model


def _legacy_wav2vec_dirs(models_root: str, float_dir: str):
    """Locate the two HF folders for the legacy .pth path: <float_dir>/<name>
    first, models/audio/<name> as the alternate
    (reference: nodes.py:70-87)."""
    dirs = []
    for name in ("wav2vec2-base-960h",
                 "wav2vec-english-speech-emotion-recognition"):
        primary = os.path.join(float_dir, name)
        alt = os.path.join(models_root, "audio", name)
        dirs.append(primary if os.path.isdir(primary)
                    else (alt if os.path.isdir(alt) else primary))
    return tuple(dirs)


def load_float_models(model: str = "FLOAT.safetensors",
                      target_device: str = "cuda",
                      advanced_float_options: Optional[dict] = None,
                      cfg: Optional[FloatConfig] = None,
                      models_root: str = "models",
                      allow_synthetic: bool = False,
                      aot_dir: Optional[str] = None,
                      w2v_cfg: Wav2Vec2Config = WAV2VEC2_BASE,
                      ser_cfg: Wav2Vec2Config = WAV2VEC2_LARGE_SER,
                      ) -> FloatPipe:
    """LoadFloatModelsOpt: unified checkpoint (or legacy float.pth + HF
    folders) -> FLOAT_PIPE on ``target_device`` (reference:
    nodes.py:23-143).

    ``model`` may be an explicit path or a bare file name resolved under
    ``<models_root>/float/``.  Missing files are downloaded when the
    environment has network access (unified: FLOAT_URL; legacy: the
    yuvraj108c/float snapshot, reference nodes.py:93-94).  A missing,
    non-downloadable checkpoint raises FileNotFoundError unless
    ``allow_synthetic=True`` asks for a random-weight pipeline.

    ``w2v_cfg`` / ``ser_cfg`` are the wav2vec2 towers' architectures of a
    unified checkpoint (the published ones by default); the legacy layout
    reads them from its HF folders.  ``aot_dir`` is accepted and ignored:
    the executable cache and the warp-flow profile beside the checkpoint
    are TPU mechanisms with no counterpart here."""
    device = node_device(target_device)
    cfg = (cfg or FloatConfig()).validate()
    cfg = apply_adv_options(cfg, advanced_float_options)
    path = _resolve_checkpoint_path(model, models_root)
    float_dir = os.path.dirname(path) or "."
    fe = DEFAULT_FE   # the bundled preprocessor_config.json settings

    if model.lower().endswith(".pth"):
        # legacy layout: float.pth + two HF folders (reference: nodes.py:66-94)
        w2v_dir, ser_dir = _legacy_wav2vec_dirs(models_root, float_dir)
        if not (os.path.exists(path) and os.path.isdir(w2v_dir)
                and os.path.isdir(ser_dir)):
            from ..io.download import snapshot_download_fallback
            snapshot_download_fallback("yuvraj108c/float", float_dir)
            w2v_dir, ser_dir = _legacy_wav2vec_dirs(models_root, float_dir)
        if os.path.exists(path):
            params = ckpt.load_legacy_checkpoint(path, w2v_dir, ser_dir)
            try:
                fe = load_preprocessor_config(w2v_dir)
            except FileNotFoundError:
                logger.warning("no preprocessor_config.json in %s; using "
                               "bundled defaults", w2v_dir)
            pipe = FloatPipeline(
                params, cfg, config_from_json(os.path.join(w2v_dir,
                                                           "config.json")),
                config_from_json(os.path.join(ser_dir, "config.json")),
                device=device)
            return FloatPipe(pipe, cfg, weights="real", fe=fe)
    else:
        if not os.path.exists(path):
            from ..io.download import ensure_model_file
            ensure_model_file(path)
        if os.path.exists(path):
            params = ckpt.load_unified_checkpoint(path)
            return FloatPipe(FloatPipeline(params, cfg, w2v_cfg, ser_cfg,
                                           device=device),
                             cfg, weights="real", fe=fe)

    if not allow_synthetic:
        raise FileNotFoundError(
            f"FLOAT checkpoint not found at {path!r} and could not be "
            "downloaded. Pass allow_synthetic=True to run with random "
            "weights (tests/benchmarks only).")
    logger.warning("checkpoint %s not found; building synthetic-weight "
                   "pipeline (allow_synthetic=True)", path)
    return FloatPipe(build_synthetic_pipeline(cfg, w2v_cfg, ser_cfg,
                                              device=device),
                     cfg, weights="synthetic", fe=fe)


@torch.inference_mode()
def float_process(ref_image: np.ndarray, ref_audio: AudioLike,
                  float_pipe: FloatPipe,
                  a_cfg_scale: float = 2.0, e_cfg_scale: float = 1.0,
                  fps: float = 25.0, emotion: str = "none",
                  face_align: bool = False, seed: int = 15,
                  progress=None,
                  ) -> Tuple[np.ndarray, AudioLike, float]:
    """FloatProcessOpt: full pipeline with image/audio batch broadcasting
    (reference: nodes.py:146-222 — pairs up to max(B_img, B_aud) items
    with last-element repeat, per-item seed + i, concatenates all frames).

    Each image is encoded once however many clips reuse it; all clips'
    decode chunks share one dispatch stream with one in-flight copy
    (``runtime.decode.decode_clips_to_host``).  ``progress(stage, i, n)``
    reports each clip's sampling and each decode chunk's arrival."""
    pipe = float_pipe.pipeline
    cfg = float_pipe.cfg.replace(fps=fps)
    img = np.asarray(ref_image)
    if img.ndim == 3:
        img = img[None]
    waves = _audio_to_waves(ref_audio, cfg.sampling_rate)
    n = max(img.shape[0], len(waves))

    clips = []
    used_audio_idx = []
    src_cache = {}          # image index -> its encoded source
    for i in range(n):
        ii = min(i, img.shape[0] - 1)
        ai = min(i, len(waves) - 1)
        used_audio_idx.append(ai)
        if ii not in src_cache:
            model_in, _bbox = comfy_image_to_model_input(
                img[ii], cfg.input_size, cfg.rgba_conversion,
                cfg.bkg_color_hex,
                face_align=face_align, face_margin=cfg.face_margin)
            src_cache[ii] = pipe.encode_image(model_in)
        wave_n = normalize_waveform(waves[ai], float_pipe.fe)[None]
        t_frames = audio_num_frames(wave_n.shape[-1], cfg)
        s_r, _lam, feats, r_s = src_cache[ii]
        wa = pipe.encode_audio(wave_n, t_frames)
        we = pipe.emotion_latent(wave_n, emotion)
        r_d = pipe.sample(r_s, wa, we, seed=seed + i,
                          a_cfg_scale=a_cfg_scale, e_cfg_scale=e_cfg_scale)
        clips.append((s_r, feats, r_d[0]))
        if progress is not None:
            progress("sample", i + 1, n)
    all_frames = decode_clips_to_host(
        pipe.syn_cast, clips, size=cfg.input_size,
        decode_batch=cfg.decode_batch,
        compute_dtype=getattr(torch, cfg.compute_dtype),
        frame_callback=_stage_cb(progress, "decode"))

    # batch > 1 returns the concatenated *used* audio so downstream video
    # muxing lines up with the frame concat (reference: nodes.py:213-222)
    out_audio: AudioLike = ref_audio
    if n > 1:
        if isinstance(ref_audio, dict):
            wf = np.asarray(ref_audio["waveform"])
            if wf.ndim == 2:
                wf = wf[None]
            cat = np.concatenate([wf[ai] for ai in used_audio_idx], axis=-1)
            out_audio = {"waveform": cat[None],
                         "sample_rate": ref_audio["sample_rate"]}
        else:
            arr = np.asarray(ref_audio, dtype=np.float32)
            if arr.ndim == 1:
                arr = arr[None]
            out_audio = np.concatenate(
                [arr[ai] for ai in used_audio_idx], axis=-1)[None]
    return np.concatenate(all_frames, axis=0), out_audio, fps


# ===========================================================================
# Advanced tier
# ===========================================================================

def float_image_face_align(image: np.ndarray, input_size: int = 512,
                           face_margin: float = 1.6, face_index: int = 1,
                           rgba_conversion: str = "blend_with_color",
                           bkg_color_hex: str = "#000000",
                           detector=None,
                           allow_fallback: bool = False) -> Tuple[np.ndarray, List[BBox]]:
    """FloatImageFaceAlign: batch face-align -> (cropped IMAGE, BBOX list)
    (reference: nodes_adv.py:38-127).  ``allow_fallback`` opts into the
    center-crop path when face_alignment is not installed (a missing
    package otherwise raises, like the reference's hard import)."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = img[None]
    crops, bboxes = [], []
    for i in range(img.shape[0]):
        u8 = image_to_uint8(img[i], rgba_conversion, bkg_color_hex)
        crop, bbox = face_align_crop(u8, input_size, margin=face_margin,
                                     index=face_index, detector=detector,
                                     allow_fallback=allow_fallback)
        crops.append(crop.astype(np.float32) / 255.0)
        bboxes.append(bbox)
    return np.stack(crops), bboxes


def float_advanced_parameters(r_cfg_scale: float = 1.0,
                              attention_window: int = 2,
                              audio_dropout_prob: float = 0.1,
                              ref_dropout_prob: float = 0.1,
                              emotion_dropout_prob: float = 0.1,
                              ode_atol: float = 1e-5, ode_rtol: float = 1e-5,
                              nfe: int = 10,
                              torchdiffeq_ode_method: str = "euler",
                              face_margin: float = 1.6,
                              rgba_conversion: str = "blend_with_color",
                              bkg_color_hex: str = "#000000") -> dict:
    """FloatAdvancedParameters -> ADV_FLOAT_DICT
    (reference: nodes_adv.py:130-235)."""
    return dict(r_cfg_scale=r_cfg_scale, attention_window=attention_window,
                audio_dropout_prob=audio_dropout_prob,
                ref_dropout_prob=ref_dropout_prob,
                emotion_dropout_prob=emotion_dropout_prob,
                ode_atol=ode_atol, ode_rtol=ode_rtol, nfe=nfe,
                torchdiffeq_ode_method=torchdiffeq_ode_method,
                face_margin=face_margin, rgba_conversion=rgba_conversion,
                bkg_color_hex=bkg_color_hex)


def float_encode_image_to_latents(float_pipe: FloatPipe, image: np.ndarray,
                                  ) -> Tuple[AppearancePipe, torch.Tensor]:
    """FloatEncodeImageToLatents: IMAGE (B,S,S,3) [0,1] -> appearance pipe +
    r_s_lambda (reference: nodes_adv.py:238-327)."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = img[None]
    if img.ndim != 4:
        raise ValueError(
            f"'image' must be (B, H, W, C), got {img.ndim}D shape {img.shape}")
    cfg = float_pipe.cfg
    if img.shape[1] != cfg.input_size or img.shape[2] != cfg.input_size:
        raise ValueError(f"expected {cfg.input_size}² input, got {img.shape}"
                         " (reference: nodes_adv.py:262-274)")
    if img.shape[3] != cfg.input_nc:
        raise ValueError(
            f"input images must have {cfg.input_nc} channels, got "
            f"{img.shape[3]} (reference: nodes_adv.py:272-274)")
    pipe = float_pipe.pipeline
    s_r, lam, feats, _r_s = pipe.encode_image(_image_to_model(img,
                                                              pipe.device))
    return AppearancePipe(h_source=s_r, feats=list(feats)), lam


@torch.inference_mode()
def float_get_identity_reference(float_pipe: FloatPipe,
                                 r_s_lambda: torch.Tensor) -> torch.Tensor:
    """FloatGetIdentityReference: r_s_lambda (B,20) -> r_s (B,512)
    (reference: nodes_adv.py:330-378)."""
    return _direction_fn(
        float_pipe.pipeline.params["synthesis"]["direction"], r_s_lambda)


def float_encode_audio_to_wa(float_pipe: FloatPipe, ref_audio: AudioLike,
                             fps: float = 25.0,
                             ) -> Tuple[torch.Tensor, int, np.ndarray]:
    """FloatEncodeAudioToLatentWA: AUDIO -> (wa (B,T,512), audio_num_frames,
    processed_audio_features (B,N)) (reference: nodes_adv.py:381-472)."""
    cfg = float_pipe.cfg.replace(fps=fps)
    waves = _audio_to_waves(ref_audio, cfg.sampling_rate)
    batch = extract_features(waves, float_pipe.fe)
    t_frames = audio_num_frames(batch.shape[1], cfg)
    wa = float_pipe.pipeline.encode_audio(batch, t_frames)
    return wa, t_frames, batch


def float_encode_emotion_to_we(float_pipe: FloatPipe,
                               processed_audio: Optional[np.ndarray] = None,
                               emotion: str = "none") -> torch.Tensor:
    """FloatEncodeEmotionToLatentWE -> we (B,1,7)
    (reference: nodes_adv.py:475-541)."""
    pipe = float_pipe.pipeline
    if emotion and emotion.lower() in EMOTION_LABELS:
        return one_hot_emotion(emotion, float_pipe.cfg.dim_e, pipe.device)
    if processed_audio is None:
        raise ValueError("emotion='none' requires processed audio")
    return pipe.predict_emotion(processed_audio)[:, None, :]


def float_sample_motion_sequence(float_pipe: FloatPipe, r_s, wa, we,
                                 audio_num_frames: Optional[int] = None,
                                 a_cfg_scale: float = 2.0,
                                 e_cfg_scale: float = 1.0,
                                 seed: int = 62064758300528,
                                 fix_noise_seed: Optional[bool] = None,
                                 ) -> torch.Tensor:
    """FloatSampleMotionSequenceRD -> r_d (B,T,512)
    (reference: nodes_adv.py:697-820; r_cfg/ODE params come from the pipe's
    options, set via advanced_float_options).  Without a fixed noise seed
    the pipeline's ``cfg.seed`` is used, as in ``float_tpu``."""
    cfg = float_pipe.cfg
    # batch-consistency validation (reference: nodes_adv.py:727-742)
    batch = wa.shape[0]
    if r_s.shape[0] != batch or we.shape[0] != batch:
        raise ValueError(
            f"batch size mismatch: wa has {batch}, r_s has {r_s.shape[0]}, "
            f"we has {we.shape[0]} — all must match")
    if r_s.ndim != 2 or wa.ndim != 3 or we.ndim != 3:
        raise ValueError(
            f"expected r_s (B,{cfg.dim_w}), wa (B,T,{cfg.dim_a}), we "
            f"(B,1|T,{cfg.dim_e}); got {tuple(r_s.shape)}, "
            f"{tuple(wa.shape)}, {tuple(we.shape)}")
    if audio_num_frames is not None and audio_num_frames != wa.shape[1]:
        logger.warning(
            "wa time dimension (%d) differs from audio_num_frames (%d); "
            "trimming/chunking to audio_num_frames",
            wa.shape[1], audio_num_frames)
        wa = wa[:, :audio_num_frames]
    use_seed = seed if (fix_noise_seed if fix_noise_seed is not None
                        else cfg.fix_noise_seed) else None
    return float_pipe.pipeline.sample(
        r_s, wa, we, seed=use_seed, a_cfg_scale=a_cfg_scale,
        e_cfg_scale=e_cfg_scale, r_cfg_scale=cfg.r_cfg_scale,
        nfe=cfg.nfe, ode_method=cfg.ode_method)


def _decode_clips(synthesis_params, appearance_pipe: AppearancePipe, r_d,
                  **decode_kw) -> np.ndarray:
    """Every batch item's frames through one ``decode_clips_to_host``
    stream, concatenated -> (B*T, S, S, 3) float32 numpy."""
    b = appearance_pipe.h_source.shape[0]
    if r_d.ndim != 3:
        raise ValueError(f"r_d must be (B, T, dim), got shape "
                         f"{tuple(r_d.shape)}")
    if r_d.shape[0] != b:
        raise ValueError(
            f"batch mismatch: appearance pipe has {b} items, r_d has "
            f"{r_d.shape[0]} (reference: nodes_adv.py:855-872)")
    clips = [(appearance_pipe.h_source[i:i + 1],
              [f[i:i + 1] for f in appearance_pipe.feats], r_d[i])
             for i in range(b)]
    return np.concatenate(decode_clips_to_host(synthesis_params, clips,
                                               **decode_kw), axis=0)


def float_decode_latents_to_images(float_pipe: FloatPipe,
                                   appearance_pipe: AppearancePipe,
                                   r_d: torch.Tensor, fps: float = 25.0,
                                   progress=None,
                                   ) -> Tuple[np.ndarray, float]:
    """FloatDecodeLatentsToImages -> (IMAGE (B*T,H,W,C), fps)
    (reference: nodes_adv.py:823-930): all batch items share one dispatch
    stream (``runtime.decode.decode_clips_to_host``).
    ``progress(stage, i, n)`` fires per decode chunk as its bytes reach
    the host."""
    cfg = float_pipe.cfg
    frames = _decode_clips(
        float_pipe.pipeline.syn_cast, appearance_pipe, r_d,
        size=cfg.input_size, decode_batch=cfg.decode_batch,
        compute_dtype=getattr(torch, cfg.compute_dtype),
        frame_callback=_stage_cb(progress, "decode"))
    return frames, fps


# ===========================================================================
# Very Advanced tier — loaders
# ===========================================================================

def _dir_fe(model_dir: str):
    """The folder's own preprocessor_config.json, bundled defaults when
    absent (the reference loads the fe per model folder,
    nodes_vadv_loader.py:139)."""
    try:
        return load_preprocessor_config(model_dir)
    except FileNotFoundError:
        logger.warning("no preprocessor_config.json in %s; using bundled "
                       "defaults", model_dir)
        return DEFAULT_FE


def load_wav2vec_model(model_dir: str, device="cuda") -> Wav2VecPipe:
    """LoadWav2VecModel: HF folder -> WAV2VEC_PIPE (model + its own feature
    extractor) on ``device`` (reference: nodes_vadv_loader.py:60-156)."""
    params, cfg, _ = load_wav2vec2_dir(model_dir)
    return Wav2VecPipe(params=tree_to_module(params, _checked_device(device)),
                       config=cfg, fe=_dir_fe(model_dir))


def load_audio_projection(path: str, device="cuda") -> AudioProjectionLayer:
    """LoadAudioProjectionLayer: projection.safetensors -> layer; dims
    inferred from '0.weight' (reference: nodes_vadv_loader.py:159-257)."""
    flat = ckpt.load_safetensors(path)
    arch = ckpt.infer_projection_arch(flat)
    return AudioProjectionLayer(
        params=tree_to_module(ckpt.flat_to_pytree(flat),
                              _checked_device(device)),
        input_dim=arch["input_dim"], output_dim=arch["output_dim"])


def load_emotion_model(model_dir: str, device="cuda") -> EmotionModelPipe:
    """LoadEmotionRecognitionModel: HF SER folder -> EMOTION_MODEL_PIPE
    (reference: nodes_vadv_loader.py:260-338)."""
    params, cfg, id2label = load_wav2vec2_dir(model_dir)
    return EmotionModelPipe(
        params=tree_to_module(params, _checked_device(device)), config=cfg,
        id2label=id2label, fe=_dir_fe(model_dir))


def load_float_encoder(path: str, device="cuda") -> EncoderModel:
    """LoadFloatEncoderModel: encoder.safetensors -> model; arch inferred
    from weights (reference: nodes_vadv_loader.py:341-473)."""
    flat = ckpt.load_safetensors(path)
    arch = ckpt.infer_encoder_arch(flat)
    return EncoderModel(
        params=tree_to_module(ckpt.flat_to_pytree(flat),
                              _checked_device(device)),
        input_size=arch["input_size"], dim=arch["dim"],
        dim_motion=arch["dim_motion"])


def safe_parse_list_str(list_str: str, expected_type=int) -> list:
    """Parse a Python-list string like "[1, 3, 3, 1]" with validation
    (reference: nodes_vadv_loader.py:37-57)."""
    import ast
    try:
        parsed = ast.literal_eval(list_str)
        if not isinstance(parsed, list):
            raise TypeError("not a list")
        if not all(isinstance(x, expected_type) for x in parsed):
            raise TypeError(f"elements must be {expected_type.__name__}")
        return parsed
    except (ValueError, TypeError, SyntaxError, MemoryError,
            RecursionError) as e:
        raise ValueError(
            f"Invalid list format {list_str!r}; use Python list syntax, "
            "e.g. '[1, 3, 3, 1]'.") from e


def load_float_synthesis(path: str, channel_multiplier: int = 1,
                         blur_kernel=(1, 3, 3, 1),
                         device="cuda") -> SynthesisModel:
    """LoadFloatSynthesisModel (reference: nodes_vadv_loader.py:476-652).
    ``blur_kernel`` accepts a tuple/list or the reference's UI string form
    ("[1, 3, 3, 1]", parsed via safe_parse_list_str)."""
    if isinstance(blur_kernel, str):
        blur_kernel = tuple(safe_parse_list_str(blur_kernel))
    flat = ckpt.load_safetensors(path)
    arch = ckpt.infer_synthesis_arch(flat)
    return SynthesisModel(
        params=tree_to_module(ckpt.flat_to_pytree(flat),
                              _checked_device(device)),
        size=arch["size"], style_dim=arch["style_dim"],
        motion_dim=arch["motion_dim"], blur_kernel=tuple(blur_kernel),
        channel_multiplier=channel_multiplier)


def load_fmt_model(path: str, dim_e: int = 7, num_heads: int = 8,
                   attention_window: int = 2, num_prev_frames: int = 10,
                   fps: float = 25.0, wav2vec_sec: float = 2.0,
                   device="cuda") -> FMTModel:
    """LoadFMTModel: fmt.safetensors -> model; dims inferred from weights,
    pos_embed/alignment_mask never loaded
    (reference: nodes_vadv_loader.py:655-866)."""
    flat = ckpt.load_safetensors(path)
    arch = ckpt.infer_fmt_arch(flat)
    dim_a = arch["c_embedder_in"] - arch["dim_w"] - dim_e
    cfg = FloatConfig(
        dim_w=arch["dim_w"], dim_h=arch["dim_h"], dim_a=dim_a, dim_e=dim_e,
        fmt_depth=arch["fmt_depth"], mlp_ratio=arch["mlp_ratio"],
        num_heads=num_heads, attention_window=attention_window,
        num_prev_frames=num_prev_frames, fps=fps, wav2vec_sec=wav2vec_sec)
    opts = dict(arch, dim_a=dim_a, dim_e=dim_e, num_heads=num_heads,
                attention_window=attention_window,
                num_prev_frames=num_prev_frames, fps=fps,
                wav2vec_sec=wav2vec_sec)
    return FMTModel(params=tree_to_module(ckpt.flat_to_pytree(flat),
                                          _checked_device(device)),
                    cfg=cfg, construction_options=opts)


# ===========================================================================
# Very Advanced tier — apply
# ===========================================================================

def _param_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def audio_preprocess_and_feature_extract(
        wav2vec_pipe: Wav2VecPipe, ref_audio: AudioLike, fps: float = 25.0,
        only_last_features: bool = False,
        ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """FloatAudioPreprocessAndFeatureExtract -> (features (B,T,9216|768),
    processed_audio (B,N), audio_num_frames)
    (reference: nodes_vadv.py:28-144)."""
    waves = _audio_to_waves(ref_audio, wav2vec_pipe.expected_sr)
    batch = extract_features(waves, wav2vec_pipe.fe)
    cfg = FloatConfig(fps=fps)
    t_frames = audio_num_frames(batch.shape[1], cfg)
    wave = pad_wave_to_frames(
        torch.as_tensor(batch, device=_param_device(wav2vec_pipe.params)),
        t_frames, cfg)
    feats = stacked_features(wav2vec_pipe.params, wave, t_frames,
                             wav2vec_pipe.config, only_last_features)
    return feats, batch, t_frames


@torch.inference_mode()
def apply_audio_projection(projection: AudioProjectionLayer,
                           features: torch.Tensor) -> torch.Tensor:
    """FloatApplyAudioProjection -> wa (B,T,512); validates feature dim
    (reference: nodes_vadv.py:147-198)."""
    if features.shape[-1] != projection.input_dim:
        raise ValueError(f"feature dim {features.shape[-1]} != projection "
                         f"input dim {projection.input_dim}")
    return _audio_projection_fn(projection.params, features)


@torch.inference_mode()
def extract_emotion(emotion_pipe: EmotionModelPipe,
                    ref_audio: Optional[AudioLike] = None,
                    emotion: str = "none") -> torch.Tensor:
    """FloatExtractEmotionWithCustomModel -> we (B,1,E): predicted scores
    or one-hot by label (reference: nodes_vadv.py:201-295)."""
    dim_e = emotion_pipe.dim_e
    device = _param_device(emotion_pipe.params)
    label2id = emotion_pipe.label2id or {
        lbl: i for i, lbl in enumerate(EMOTION_LABELS)}
    if emotion and emotion.lower() in label2id:
        idx = torch.tensor([[label2id[emotion.lower()]]], device=device)
        return F.one_hot(idx, dim_e).float()
    if ref_audio is None:
        raise ValueError("emotion='none' requires audio")
    waves = _audio_to_waves(ref_audio, emotion_pipe.fe.sampling_rate)
    batch, mask = extract_features(waves, emotion_pipe.fe, return_mask=True)
    # xlsr-style SER configs set return_attention_mask=true: the extractor
    # mask shapes the encoder pass (reference: wav2vec2_ser.py:77-86 +
    # nodes_vadv.py:229-252); mask-free configs pass None
    am = (torch.as_tensor(mask, device=device)
          if emotion_pipe.fe.return_attention_mask else None)
    return _predict_emotion(emotion_pipe.params,
                            torch.as_tensor(batch, device=device),
                            emotion_pipe.config,
                            attention_mask=am)[:, None, :]


@torch.inference_mode()
def extract_emotion_dynamic(emotion_pipe: EmotionModelPipe,
                            ref_audio: AudioLike,
                            total_video_frames: int,
                            chunk_duration_sec: float = 2.0,
                            sample_rate: int = 16000,
                            ) -> Tuple[torch.Tensor, np.ndarray]:
    """FloatExtractEmotionWithCustomModelDyn -> (we (B,T,E),
    emotion_sequence (B,num_chunks,E)): per-window SER + nearest-neighbour
    upsampling to the frame grid (reference: nodes_vadv.py:738-844)."""
    device = _param_device(emotion_pipe.params)
    waves = _audio_to_waves(ref_audio, sample_rate)
    chunk_len = int(chunk_duration_sec * sample_rate)
    scores_per_item = []
    for wave in waves:
        n_chunks = max(1, math.ceil(len(wave) / chunk_len))
        chunk_scores = []
        for ci in range(n_chunks):
            chunk = wave[ci * chunk_len:(ci + 1) * chunk_len]
            if len(chunk) == 0:
                break
            feats = extract_features([chunk], emotion_pipe.fe)
            s = _predict_emotion(emotion_pipe.params,
                                 torch.as_tensor(feats, device=device),
                                 emotion_pipe.config)
            chunk_scores.append(s[0].cpu().numpy())
        scores_per_item.append(np.stack(chunk_scores))
    seq = np.stack(scores_per_item)                       # (B, n_chunks, E)
    we = nearest_interpolate_time(torch.as_tensor(seq, device=device),
                                  total_video_frames)
    return we, seq


@torch.inference_mode()
def apply_float_encoder(encoder_model: EncoderModel, image: np.ndarray,
                        ) -> Tuple[AppearancePipe, torch.Tensor]:
    """ApplyFloatEncoder (reference: nodes_vadv.py:298-367)."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = img[None]
    x = _image_to_model(img, _param_device(encoder_model.params))
    s_r, lam, feats = _encode_image_fn(encoder_model.params, x,
                                       encoder_model.input_size)
    return AppearancePipe(h_source=s_r, feats=list(feats)), lam


@torch.inference_mode()
def get_identity_reference_va(synthesis_model: SynthesisModel,
                              r_s_lambda: torch.Tensor) -> torch.Tensor:
    """FloatGetIdentityReferenceVA (reference: nodes_vadv.py:479-531)."""
    return _direction_fn(synthesis_model.params["direction"], r_s_lambda)


@torch.inference_mode()
def sample_motion_sequence_va(fmt_model: FMTModel, r_s, wa, we,
                              audio_num_frames: Optional[int] = None,
                              a_cfg_scale: float = 2.0,
                              r_cfg_scale: float = 1.0,
                              e_cfg_scale: float = 1.0,
                              include_r_cfg: bool = False,
                              nfe: int = 10, ode_method: str = "euler",
                              ode_atol: float = 1e-5, ode_rtol: float = 1e-5,
                              audio_dropout_prob: float = 0.0,
                              ref_dropout_prob: float = 0.0,
                              emotion_dropout_prob: float = 0.0,
                              seed: int = 62064758300528,
                              fix_noise_seed: bool = True) -> torch.Tensor:
    """FloatSampleMotionSequenceRD_VA: full-control sampler
    (reference: nodes_vadv.py:534-735), noise from a ``torch.Generator``
    on wa's device seeded with ``seed`` (a fresh entropy seed without
    ``fix_noise_seed``).

    The dropout probabilities are accepted for surface parity but have no
    effect at inference — the reference patches them onto fmt.opt yet
    runs with train=False, where sequence dropout is skipped
    (FMT.py:271-275)."""
    cfg = fmt_model.cfg.replace(nfe=nfe, ode_method=ode_method,
                                ode_atol=ode_atol, ode_rtol=ode_rtol,
                                include_r_cfg=include_r_cfg)
    if audio_num_frames is not None and audio_num_frames != wa.shape[1]:
        wa = wa[:, :audio_num_frames]
    gen = torch.Generator(device=wa.device)
    gen.manual_seed(seed if fix_noise_seed else
                    np.random.SeedSequence().entropy % (2 ** 63))
    return sample_motion_latents(fmt_model.params, r_s.float(), wa.float(),
                                 we.float(), cfg=cfg, generator=gen,
                                 a_cfg_scale=a_cfg_scale,
                                 e_cfg_scale=e_cfg_scale,
                                 r_cfg_scale=r_cfg_scale,
                                 nfe=nfe, ode_method=ode_method)


def apply_float_synthesis(synthesis_model: SynthesisModel,
                          appearance_pipe: AppearancePipe,
                          r_d: torch.Tensor, fps: float = 25.0,
                          decode_batch: int = 8,
                          use_warp_kernel: bool = True,
                          ) -> Tuple[np.ndarray, float]:
    """ApplyFloatSynthesis -> (IMAGE (B*T,H,W,C), fps)
    (reference: nodes_vadv.py:370-475): all batch items through one
    ``decode_clips_to_host`` stream, in float32 as ``float_tpu``'s decode
    here.

    ``use_warp_kernel`` is accepted for ``float_tpu``'s signature and
    ignored: the port's warps take the CUDA kernels on the card and the
    plain PyTorch versions on the CPU, and both are exact."""
    frames = _decode_clips(
        synthesis_model.params, appearance_pipe, r_d,
        size=synthesis_model.size, decode_batch=decode_batch,
        blur_kernel=tuple(synthesis_model.blur_kernel))
    return frames, fps
