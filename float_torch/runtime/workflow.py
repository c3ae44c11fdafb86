"""JSON workflow runner — executes node-graph topologies from a config
(twin of ``float_tpu.runtime.workflow``).

Covers the reference's example_workflows (SURVEY §3.3/§3.5) and the 5
BASELINE benchmark configs:

1. default:       one-shot pipeline (FloatProcess equivalent)
2. emotion:       default + emotion label / cfg scales
3. long-audio:    same path (chunked sampling streams any length)
4. dynamic:       per-frame emotion via windowed SER + nearest upsampling
5. very_advanced: split-stage pipeline with face-align + reinsert
                  compositing, multiple faces

Config keys: image, audio (file paths or arrays), checkpoint, mode
("default" | "dynamic_emotion" | "insert"), emotion, a_cfg_scale,
e_cfg_scale, fps, seed, face_align, faces (list of 1-based indices),
chunk_duration_sec.  The models run on the card unless ``run_workflow``
is given ``device="cpu"`` (or a preloaded ``pipe``).
"""
from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np

logger = logging.getLogger("float_torch.workflow")


def _load_image(spec) -> np.ndarray:
    if isinstance(spec, np.ndarray):
        return spec
    from ..image.transform import load_image_file
    return load_image_file(spec)


def _load_audio(spec) -> np.ndarray:
    from ..audio.resample import read_wav_file, resample, to_mono
    if isinstance(spec, np.ndarray):
        return spec
    if spec.endswith(".npy"):
        return np.load(spec).astype(np.float32)
    arr, sr = read_wav_file(spec)
    return resample(to_mono(arr), sr, 16000)


def run_workflow(wf: Dict[str, Any], output: str = "out",
                 pipe=None, progress=None, device: str = "cuda") -> np.ndarray:
    """Execute a workflow config; returns the generated frames and writes
    ``output``.npy (frames) when requested.  ``pipe`` (a FloatPipe)
    overrides checkpoint loading (tests / preloaded models), else the
    checkpoint loads onto ``device``; ``progress(stage, i, n)`` is
    threaded through to the stage calls."""
    from ..api import nodes as N

    mode = wf.get("mode", "default")
    if pipe is None:
        pipe = N.load_float_models(
            wf.get("checkpoint", "FLOAT.safetensors"), target_device=device,
            advanced_float_options=wf.get("advanced_options"),
            models_root=wf.get("models_root", "models"),
            allow_synthetic=wf.get("allow_synthetic", False))
    img = _load_image(wf["image"])
    wave = _load_audio(wf["audio"])
    fps = wf.get("fps", 25.0)
    seed = wf.get("seed", 15)
    a_cfg = wf.get("a_cfg_scale", 2.0)
    e_cfg = wf.get("e_cfg_scale", 1.0)
    emotion = wf.get("emotion", "none")

    if mode == "default":
        frames, _, _ = N.float_process(
            img[None], wave[None], pipe, a_cfg_scale=a_cfg,
            e_cfg_scale=e_cfg, fps=fps, emotion=emotion,
            face_align=wf.get("face_align", False), seed=seed,
            progress=progress)

    elif mode == "dynamic_emotion":
        cfg = pipe.cfg.replace(fps=fps)
        aligned, _ = N.float_image_face_align(
            img[None], cfg.input_size,
            allow_fallback=wf.get("face_align") == "fallback") \
            if wf.get("face_align") else (img[None], None)
        app, lam = N.float_encode_image_to_latents(pipe, aligned)
        r_s = N.float_get_identity_reference(pipe, lam)
        wa, t_frames, processed = N.float_encode_audio_to_wa(pipe, wave[None], fps)
        from ..api.types import EmotionModelPipe
        emo_pipe = EmotionModelPipe(params=pipe.pipeline.params["emotion"],
                                    config=pipe.pipeline.ser_cfg)
        we, _seq = N.extract_emotion_dynamic(
            emo_pipe, wave[None], t_frames,
            chunk_duration_sec=wf.get("chunk_duration_sec", 2.0))
        r_d = N.float_sample_motion_sequence(pipe, r_s, wa, we,
                                             a_cfg_scale=a_cfg,
                                             e_cfg_scale=e_cfg, seed=seed)
        frames, _ = N.float_decode_latents_to_images(pipe, app, r_d, fps,
                                                     progress=progress)

    elif mode == "insert":
        from ..image.composite import composite_face_frames
        faces = wf.get("faces", [1])
        composited = None
        for face_idx in faces:
            aligned, bboxes = N.float_image_face_align(
                img[None], pipe.cfg.input_size,
                face_margin=pipe.cfg.face_margin, face_index=face_idx,
                allow_fallback=wf.get("face_align") == "fallback")
            frames_f, _, _ = N.float_process(
                aligned, wave[None], pipe, a_cfg_scale=a_cfg,
                e_cfg_scale=e_cfg, fps=fps, emotion=emotion,
                seed=seed + face_idx - 1, progress=progress)
            bg = composited if composited is not None else img
            composited = composite_face_frames(
                bg, frames_f, bboxes[0], feather=wf.get("feather", 0),
                inplace=composited is not None)   # faces 2..n patch in place
        frames = composited

    else:
        raise ValueError(f"unknown workflow mode {mode!r}")

    if output:
        np.save(output + ".npy" if not output.endswith(".npy") else output,
                frames)
        logger.info("wrote %s (%s frames)", output, frames.shape[0])
    return frames
