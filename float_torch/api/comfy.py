"""Adapter registry: ComfyUI node types -> float_torch node functions
(twin of ``float_tpu.api.comfy``).

With runtime/graph.py this executes the reference's example workflow
JSONs (all FLOAT node types, SURVEY §2.8) plus the host nodes those
graphs rely on (LoadImage/LoadAudio, VHS_VideoCombine, PreviewImage,
Primitive*, and the author's SET_* sibling-package nodes: resampler,
downloaders, face compositing — reference SURVEY §3.5).

Each adapter takes ``(ctx, inputs)`` — widget values and resolved link
values merged by input name — and returns the node's outputs in its
canonical slot order (the RETURN order serialized in the reference
workflows).  Models load onto ``GraphContext.device`` (the card unless
the caller asks for the CPU); a ``target_device`` widget of "cpu" puts
that node's pipeline on the CPU, any other value ("cuda", "tpu") leaves
it on the context's device.  The ``cudnn_benchmark`` widget is accepted
and ignored.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..io.download import FLOAT_UNIFIED_MODEL, ensure_model_part_exists
from ..runtime.graph import run_graph

logger = logging.getLogger("float_torch.comfy")

ADAPTERS: Dict[str, Callable] = {}


def adapter(*names):
    def deco(fn):
        for n in names:
            ADAPTERS[n] = fn
        return fn
    return deco


@dataclass
class GraphContext:
    """Execution context: IO roots, overrides, injected models.

    ``overrides`` maps a node selector (type name, title, or flattened
    exec key) to ``{input_name: value}`` patched over that node's inputs —
    the CLI's --set and the tests' tiny-config injection both use this.
    ``float_pipe`` short-circuits LoadFloatModelsOpt (preloaded/tiny
    pipelines, mirroring runtime.workflow.run_workflow(pipe=...)).
    ``device``: where the graph's models load and run, "cuda" unless the
    caller passes "cpu".
    """
    device: str = "cuda"
    models_root: str = "models"
    inputs_dir: str = "."
    output_dir: str = "."
    overrides: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    float_pipe: Any = None
    allow_synthetic: bool = False
    progress: Any = None
    artifacts: List[str] = field(default_factory=list)

    def resolve_input_file(self, name: str) -> str:
        if os.path.exists(name):
            return name
        return os.path.join(self.inputs_dir, name)

    def out_path(self, name: str) -> str:
        """Full output path; filename_prefix may imply subfolders
        (ComfyUI convention, e.g. 'float/out')."""
        path = os.path.join(self.output_dir, name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return path


def _g(inputs: dict, name: str, default=None):
    """inputs[name], treating an unconnected (None) input as absent."""
    v = inputs.get(name)
    return default if v is None else v


def run_comfy_workflow(wf, ctx: Optional[GraphContext] = None,
                       **ctx_kwargs):
    """Execute a ComfyUI workflow JSON (path or dict).  Returns
    (results, ctx) — results: {exec_key: [outputs]}; ctx.artifacts lists
    the files written by output nodes."""
    if ctx is None:
        ctx = GraphContext(**ctx_kwargs)
    return run_graph(wf, ADAPTERS, ctx), ctx


# ---------------------------------------------------------------------------
# host IO nodes
# ---------------------------------------------------------------------------

def _read_audio_file(path: str) -> dict:
    """wav/npy -> ComfyUI AUDIO dict {'waveform': (1, C, N), 'sample_rate'}."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        return {"waveform": arr[None], "sample_rate": 16000}
    from ..audio.resample import read_wav_file
    arr, sr = read_wav_file(path)
    return {"waveform": arr[None], "sample_rate": sr}


def _load_image_as_comfy(path: str):
    """-> (IMAGE (1,H,W,3) float [0,1], MASK (1,H,W): 1-alpha or zeros).

    ComfyUI's LoadImage always emits 3-channel RGB, moving alpha into the
    MASK output — downstream nodes (encoders, video writers) rely on it.
    """
    from ..image.transform import load_image_file
    img = load_image_file(path)
    mask = np.zeros(img.shape[:2], np.float32)
    if img.shape[-1] == 4:
        mask = 1.0 - img[..., 3]
        img = img[..., :3]
    return img[None], mask[None]


@adapter("LoadImage")
def _load_image(ctx, inputs):
    img, mask = _load_image_as_comfy(
        ctx.resolve_input_file(_g(inputs, "image", "input.png")))
    return [img, mask]


@adapter("LoadAudio")
def _load_audio(ctx, inputs):
    return [_read_audio_file(
        ctx.resolve_input_file(_g(inputs, "audio", "input.wav")))]


@adapter("SET_ImageDownload")
def _set_image_download(ctx, inputs):
    """Sibling-package download node: local file if present, else fetch
    base_url+filename; image_bypass passes straight through."""
    if _g(inputs, "image_bypass") is not None:
        return [inputs["image_bypass"], _g(inputs, "mask_bypass")]
    name = _g(inputs, "filename", "input.png")
    path = ctx.resolve_input_file(name)
    if not os.path.exists(path):
        from ..io.download import download_file
        url = _g(inputs, "base_url", "") + name
        if not download_file(url, path):
            raise FileNotFoundError(f"{path} missing and {url} unreachable")
    img, mask = _load_image_as_comfy(path)
    return [img, mask]


@adapter("SET_AudioDownload")
def _set_audio_download(ctx, inputs):
    if _g(inputs, "audio_bypass") is not None:
        return [inputs["audio_bypass"]]
    name = _g(inputs, "filename", "input.wav")
    path = ctx.resolve_input_file(name)
    if not os.path.exists(path):
        from ..io.download import download_file
        url = _g(inputs, "base_url", "") + name
        if not download_file(url, path):
            raise FileNotFoundError(f"{path} missing and {url} unreachable")
    audio = _read_audio_file(path)
    target_sr = int(_g(inputs, "target_sample_rate", 0) or 0)
    if target_sr and target_sr != audio["sample_rate"]:
        audio = _resample_audio_dict(audio, target_sr)
    return [audio]


def _resample_audio_dict(audio: dict, target_sr: int) -> dict:
    from ..audio.resample import resample
    wf = np.asarray(audio["waveform"])          # (B, C, N)
    sr = audio["sample_rate"]
    out = np.stack([np.stack([resample(wf[b, c], sr, target_sr)
                              for c in range(wf.shape[1])])
                    for b in range(wf.shape[0])])
    return {"waveform": out, "sample_rate": target_sr}


@adapter("SET_AudioChannelConvResampler")
def _audio_conv_resample(ctx, inputs):
    from ..audio.resample import to_mono
    audio = inputs["audio"]
    wf = np.asarray(audio["waveform"])
    conv = _g(inputs, "channel_conversion", "force_mono")
    if conv == "force_mono" and wf.shape[1] > 1:
        wf = np.stack([to_mono(wf[b]) for b in range(wf.shape[0])])[:, None]
    elif conv == "force_stereo" and wf.shape[1] == 1:
        wf = np.repeat(wf, 2, axis=1)
    audio = {"waveform": wf, "sample_rate": audio["sample_rate"]}
    target_sr = int(_g(inputs, "target_sample_rate", 0) or 0)
    if target_sr and target_sr != audio["sample_rate"]:
        audio = _resample_audio_dict(audio, target_sr)
    return [audio]


@adapter("PrimitiveFloat")
def _primitive_float(ctx, inputs):
    return [float(_g(inputs, "value", 0.0))]


@adapter("PrimitiveInt")
def _primitive_int(ctx, inputs):
    return [int(_g(inputs, "value", 0))]


@adapter("PrimitiveString", "PrimitiveStringMultiline")
def _primitive_string(ctx, inputs):
    return [str(_g(inputs, "value", ""))]


@adapter("PrimitiveBoolean")
def _primitive_bool(ctx, inputs):
    return [bool(_g(inputs, "value", False))]


@adapter("PreviewImage", "SaveImage")
def _save_images(ctx, inputs):
    images = inputs.get("images")
    if images is None:
        return []
    path = ctx.out_path(
        f"{_g(inputs, 'filename_prefix', 'preview')}_"
        f"{len(ctx.artifacts):03d}.npy")
    np.save(path, np.asarray(images))
    ctx.artifacts.append(path)
    return []


@adapter("VHS_VideoCombine")
def _video_combine(ctx, inputs):
    from ..io.video import write_video
    frames = np.asarray(inputs["images"])
    fps = float(_g(inputs, "frame_rate", 25.0))
    prefix = _g(inputs, "filename_prefix", "float_torch")
    path = ctx.out_path(f"{prefix}_{len(ctx.artifacts):05d}.mp4")
    audio = _g(inputs, "audio")
    mono = None
    if audio is not None:
        from ..audio.resample import comfy_audio_to_mono_16k
        mono = comfy_audio_to_mono_16k(audio)
    write_video(path, frames, fps, audio=mono, sample_rate=16000)
    ctx.artifacts.append(path)
    return [[path]]


# ---------------------------------------------------------------------------
# FLOAT nodes — Regular + Advanced tiers
# ---------------------------------------------------------------------------

@adapter("LoadFloatModelsOpt")
def _load_float_models(ctx, inputs):
    if ctx.float_pipe is not None:
        return [ctx.float_pipe]
    from . import nodes as N
    target = _g(inputs, "target_device", "cuda")
    audio_cfgs = {k: inputs[k] for k in ("w2v_cfg", "ser_cfg")
                  if inputs.get(k) is not None}
    pipe = N.load_float_models(
        model=_g(inputs, "model", FLOAT_UNIFIED_MODEL),
        target_device="cpu" if str(target).lower() == "cpu" else ctx.device,
        advanced_float_options=_g(inputs, "advanced_float_options"),
        cfg=_g(inputs, "cfg"),
        models_root=_g(inputs, "models_root", ctx.models_root),
        allow_synthetic=bool(_g(inputs, "allow_synthetic",
                                ctx.allow_synthetic)), **audio_cfgs)
    return [pipe]


@adapter("FloatProcessOpt")
def _float_process(ctx, inputs):
    from . import nodes as N
    frames, used_audio, fps = N.float_process(
        ref_image=inputs["ref_image"], ref_audio=inputs["ref_audio"],
        float_pipe=inputs["float_pipe"],
        a_cfg_scale=float(_g(inputs, "a_cfg_scale", 2.0)),
        e_cfg_scale=float(_g(inputs, "e_cfg_scale", 1.0)),
        fps=float(_g(inputs, "fps", 25.0)),
        emotion=_g(inputs, "emotion", "none"),
        face_align=bool(_g(inputs, "face_align", False)),
        seed=int(_g(inputs, "seed", 15)), progress=ctx.progress)
    return [frames, used_audio, fps]


@adapter("FloatImageFaceAlign")
def _face_align(ctx, inputs):
    from . import nodes as N
    crops, bboxes = N.float_image_face_align(
        image=inputs["image"],
        input_size=int(_g(inputs, "size", 512)),
        face_margin=float(_g(inputs, "face_margin", 1.6)),
        # the node's widget is named 'index' (reference nodes_adv.py:81);
        # 'face_index' accepted as an override alias
        face_index=int(_g(inputs, "index", _g(inputs, "face_index", 1))),
        rgba_conversion=_g(inputs, "rgba_conversion", "blend_with_color"),
        bkg_color_hex=_g(inputs, "bkg_color_hex", "#000000"),
        detector=_g(inputs, "detector"),
        allow_fallback=bool(_g(inputs, "allow_fallback", False)))
    return [crops, bboxes]


@adapter("FloatAdvancedParameters")
def _advanced_parameters(ctx, inputs):
    from . import nodes as N
    known = ("r_cfg_scale", "attention_window", "audio_dropout_prob",
             "ref_dropout_prob", "emotion_dropout_prob", "ode_atol",
             "ode_rtol", "nfe", "torchdiffeq_ode_method", "face_margin",
             "rgba_conversion", "bkg_color_hex")
    kw = {k: inputs[k] for k in known if inputs.get(k) is not None}
    return [N.float_advanced_parameters(**kw)]


@adapter("FloatEncodeImageToLatents")
def _encode_image(ctx, inputs):
    from . import nodes as N
    app, lam = N.float_encode_image_to_latents(
        inputs["float_pipe"], inputs["ref_image"])
    return [app, lam, inputs["float_pipe"]]


@adapter("FloatGetIdentityReference")
def _get_identity(ctx, inputs):
    from . import nodes as N
    r_s = N.float_get_identity_reference(
        inputs["float_pipe"], inputs["r_s_lambda_latent"])
    return [r_s, inputs["float_pipe"]]


@adapter("FloatEncodeAudioToLatentWA")
def _encode_audio(ctx, inputs):
    from . import nodes as N
    wa, t, processed = N.float_encode_audio_to_wa(
        inputs["float_pipe"], inputs["audio"],
        fps=float(_g(inputs, "fps", 25.0)))
    return [wa, t, processed, inputs["float_pipe"]]


@adapter("FloatEncodeEmotionToLatentWE")
def _encode_emotion(ctx, inputs):
    from . import nodes as N
    we = N.float_encode_emotion_to_we(
        inputs["float_pipe"],
        processed_audio=_g(inputs, "processed_audio_features"),
        emotion=_g(inputs, "emotion", "none"))
    return [we, inputs["float_pipe"]]


@adapter("FloatSampleMotionSequenceRD")
def _sample_rd(ctx, inputs):
    from . import nodes as N
    r_d = N.float_sample_motion_sequence(
        inputs["float_pipe"], inputs["r_s_latent"], inputs["wa_latent"],
        inputs["we_latent"],
        audio_num_frames=_g(inputs, "audio_num_frames"),
        a_cfg_scale=float(_g(inputs, "a_cfg_scale", 2.0)),
        e_cfg_scale=float(_g(inputs, "e_cfg_scale", 1.0)),
        seed=int(_g(inputs, "seed", 62064758300528)))
    return [r_d, inputs["float_pipe"]]


@adapter("FloatDecodeLatentsToImages")
def _decode_latents(ctx, inputs):
    from . import nodes as N
    pipe = inputs["float_pipe"]
    frames, fps = N.float_decode_latents_to_images(
        pipe, inputs["appearance_pipe"], inputs["r_d_latents"],
        fps=float(_g(inputs, "fps", pipe.cfg.fps)), progress=ctx.progress)
    return [frames, fps, pipe]


# ---------------------------------------------------------------------------
# FLOAT nodes — Very Advanced loaders
# ---------------------------------------------------------------------------

def _resolve_part_file(ctx, name: str, subdir: str, part_key: str) -> str:
    """Model-store resolution for VA part files: explicit path, then
    <models_root>/<subdir>/, then <models_root>/float/; as a last resort
    extract from the unified checkpoint / download
    (reference: nodes_vadv_loader.py:29-34 + utils/downloader.py:44-125)."""
    if os.path.exists(name):
        return name
    candidates = [os.path.join(ctx.models_root, subdir, name),
                  os.path.join(ctx.models_root, "float", name)]
    for c in candidates:
        if os.path.exists(c):
            return c
    unified = os.path.join(ctx.models_root, "float", FLOAT_UNIFIED_MODEL)
    got = ensure_model_part_exists(part_key, candidates[0],
                                   unified_model_path=unified)
    if got:
        return got
    raise FileNotFoundError(
        f"model part {name!r} not found (tried {candidates}, extraction "
        f"from {unified}, download)")


def _resolve_model_dir(ctx, folder: str) -> str:
    if os.path.isdir(folder):
        return folder
    for sub in ("audio", "float"):
        c = os.path.join(ctx.models_root, sub, folder)
        if os.path.isdir(c):
            return c
    raise FileNotFoundError(
        f"model dir {folder!r} not found under {ctx.models_root}/audio or "
        f"{ctx.models_root}/float")


@adapter("LoadWav2VecModel")
def _load_wav2vec(ctx, inputs):
    from . import nodes as N
    pipe = N.load_wav2vec_model(
        _resolve_model_dir(ctx, _g(inputs, "model_folder",
                                   "wav2vec2-base-960h")), device=ctx.device)
    return [pipe.expected_sr, pipe]


@adapter("LoadAudioProjectionLayer")
def _load_projection(ctx, inputs):
    from . import nodes as N
    layer = N.load_audio_projection(_resolve_part_file(
        ctx, _g(inputs, "projection_file", "projection.safetensors"),
        "float/audio_projections", "projection"), device=ctx.device)
    return [layer, layer.input_dim, layer.output_dim]


@adapter("LoadEmotionRecognitionModel")
def _load_emotion_model(ctx, inputs):
    from . import nodes as N
    pipe = N.load_emotion_model(_resolve_model_dir(
        ctx, _g(inputs, "model_folder",
                "wav2vec-english-speech-emotion-recognition")),
        device=ctx.device)
    return [pipe, pipe.dim_e]


@adapter("LoadFloatEncoderModel")
def _load_encoder_model(ctx, inputs):
    from . import nodes as N
    enc = N.load_float_encoder(_resolve_part_file(
        ctx, _g(inputs, "encoder_file", "encoder.safetensors"),
        "float/motion_autoencoder", "encoder"), device=ctx.device)
    return [enc.input_size, enc.dim, enc.dim_motion, enc]


@adapter("LoadFloatSynthesisModel")
def _load_synthesis_model(ctx, inputs):
    from . import nodes as N
    syn = N.load_float_synthesis(
        _resolve_part_file(
            ctx, _g(inputs, "synthesis_file", "decoder.safetensors"),
            "float/motion_autoencoder", "decoder"),
        channel_multiplier=int(_g(inputs, "channel_multiplier", 1)),
        blur_kernel=_g(inputs, "blur_kernel_str", "[1, 3, 3, 1]"),
        device=ctx.device)
    return [syn, syn.size, syn.style_dim, syn.motion_dim]


@adapter("LoadFMTModel")
def _load_fmt_model(ctx, inputs):
    from . import nodes as N
    fps = float(_g(inputs, "fps", 25.0))
    wav2vec_sec = float(_g(inputs, "wav2vec_sec", 2.0))
    num_prev = int(_g(inputs, "num_prev_frames", 10))
    fmt = N.load_fmt_model(
        _resolve_part_file(ctx, _g(inputs, "fmt_file", "fmt.safetensors"),
                           "float/fmt", "fmt"),
        dim_e=int(_g(inputs, "dim_e", 7)),
        num_heads=int(_g(inputs, "num_heads", 8)),
        attention_window=int(_g(inputs, "attention_window", 2)),
        num_prev_frames=num_prev, fps=fps, wav2vec_sec=wav2vec_sec,
        device=ctx.device)
    # conditioning_chunk_size = prev + current frames (reference:
    # nodes_vadv_loader.py:864 — int(num_prev_frames + wav2vec_sec * fps))
    return [fmt, fps, dict(fmt.construction_options),
            int(num_prev + wav2vec_sec * fps)]


# ---------------------------------------------------------------------------
# FLOAT nodes — Very Advanced apply
# ---------------------------------------------------------------------------

@adapter("FloatAudioPreprocessAndFeatureExtract")
def _audio_preprocess(ctx, inputs):
    from . import nodes as N
    fps = float(_g(inputs, "target_fps", 25.0))
    feats, processed, t = N.audio_preprocess_and_feature_extract(
        inputs["wav2vec_pipe"], inputs["audio"], fps=fps,
        only_last_features=bool(_g(inputs, "only_last_features", False)))
    return [feats, t, processed, inputs["wav2vec_pipe"],
            inputs["audio"], fps]


@adapter("FloatApplyAudioProjection")
def _apply_projection(ctx, inputs):
    from . import nodes as N
    wa = N.apply_audio_projection(inputs["projection_layer"],
                                  inputs["wav2vec_features"])
    return [wa]


@adapter("FloatExtractEmotionWithCustomModel")
def _extract_emotion(ctx, inputs):
    from . import nodes as N
    we = N.extract_emotion(
        inputs["emotion_model_pipe"],
        ref_audio=_g(inputs, "processed_audio_features"),
        emotion=_g(inputs, "emotion", "none"))
    return [we, inputs["emotion_model_pipe"]]


@adapter("FloatExtractEmotionWithCustomModelDyn")
def _extract_emotion_dyn(ctx, inputs):
    from . import nodes as N
    pipe = inputs["emotion_model_pipe"]
    fps = float(_g(inputs, "target_fps", 25.0))
    sr = pipe.fe.sampling_rate
    # frame count straight from the AUDIO payload (no resample pass just
    # to measure duration; extract_emotion_dynamic converts internally)
    audio = inputs["audio"]
    if isinstance(audio, dict):
        n, sr_in = np.asarray(audio["waveform"]).shape[-1], \
            audio["sample_rate"]
    else:
        n, sr_in = np.asarray(audio).shape[-1], sr
    total = max(1, math.ceil(n / sr_in * fps))
    we, seq = N.extract_emotion_dynamic(
        pipe, inputs["audio"], total_video_frames=total,
        chunk_duration_sec=float(_g(inputs, "chunk_duration_sec", 2.0)),
        sample_rate=sr)
    return [we, pipe, seq]


@adapter("ApplyFloatEncoder")
def _apply_encoder(ctx, inputs):
    from . import nodes as N
    app, lam = N.apply_float_encoder(inputs["float_encoder"],
                                     inputs["ref_image"])
    return [app, lam, inputs["float_encoder"]]


@adapter("FloatGetIdentityReferenceVA")
def _get_identity_va(ctx, inputs):
    from . import nodes as N
    r_s = N.get_identity_reference_va(inputs["float_synthesis"],
                                      inputs["r_s_lambda_latent"])
    return [inputs["float_synthesis"], r_s]


@adapter("FloatSampleMotionSequenceRD_VA")
def _sample_rd_va(ctx, inputs):
    from . import nodes as N
    r_d = N.sample_motion_sequence_va(
        inputs["float_fmt_model"], inputs["r_s_latent"],
        inputs["wa_latent"], inputs["we_latent"],
        audio_num_frames=_g(inputs, "audio_num_frames"),
        a_cfg_scale=float(_g(inputs, "a_cfg_scale", 2.0)),
        r_cfg_scale=float(_g(inputs, "r_cfg_scale", 1.0)),
        e_cfg_scale=float(_g(inputs, "e_cfg_scale", 1.0)),
        include_r_cfg=bool(_g(inputs, "include_r_cfg", False)),
        nfe=int(_g(inputs, "nfe", 10)),
        ode_method=_g(inputs, "torchdiffeq_ode_method", "euler"),
        ode_atol=float(_g(inputs, "ode_atol", 1e-5)),
        ode_rtol=float(_g(inputs, "ode_rtol", 1e-5)),
        audio_dropout_prob=float(_g(inputs, "audio_dropout_prob", 0.0)),
        ref_dropout_prob=float(_g(inputs, "ref_dropout_prob", 0.0)),
        emotion_dropout_prob=float(_g(inputs, "emotion_dropout_prob", 0.0)),
        seed=int(_g(inputs, "seed", 62064758300528)),
        fix_noise_seed=bool(_g(inputs, "fix_noise_seed", True)))
    return [r_d, inputs["float_fmt_model"]]


@adapter("ApplyFloatSynthesis")
def _apply_synthesis(ctx, inputs):
    from . import nodes as N
    frames, _fps = N.apply_float_synthesis(
        inputs["float_synthesis"], inputs["appearance_pipe"],
        inputs["r_d_latents"])
    return [frames, inputs["float_synthesis"]]


# ---------------------------------------------------------------------------
# SET_* compositing (sibling package; equivalents per SURVEY §3.5)
# ---------------------------------------------------------------------------

def _composite(ctx, inputs, frame_by_frame: bool):
    from ..image.composite import composite_face_frames
    animated = np.asarray(inputs["animated"], np.float32)   # (T, S, S, 3)
    reference = np.asarray(inputs["reference"], np.float32)  # (B, H, W, C)
    bboxes = inputs["bboxes"]
    bbox = tuple(bboxes[0]) if isinstance(bboxes, (list, tuple)) \
        else tuple(np.asarray(bboxes).reshape(-1, 4)[0])
    if reference.shape[-1] == 4:
        reference = reference[..., :3]
    bg = reference if (frame_by_frame
                       and reference.shape[0] == animated.shape[0]) \
        else reference[0]
    return [composite_face_frames(bg, animated[..., :3], bbox)]


@adapter("SET_CompositeFace")
def _composite_face(ctx, inputs):
    return _composite(ctx, inputs, frame_by_frame=False)


@adapter("SET_CompositeFaceFrameByFrame")
def _composite_face_fbf(ctx, inputs):
    return _composite(ctx, inputs, frame_by_frame=True)
