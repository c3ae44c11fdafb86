"""Traffic kind ``scene``: one client, back-to-back two-face scenes, the
reinsert path of the reference's Very Advanced workflow (BASELINE config
5).  The orchestration is a frozen copy of
``float_torch/tools/configs_bench.py``'s ``config5``: for each of the
configuration's fixed detector boxes, the aligned square crop of the face
(``image.face_align.face_align_crop``), the image, audio and emotion
encoders, the sampler and ``decode_to_host`` on the uint8 wire; then every
scene frame composited on the host (``image.composite
.composite_faces_stream``).

Mix parameters: ``seconds`` of audio a scene; each scene its own seeded
uint8 scene, wave and one sampler seed a face.  The traced run's scenes
carry spans around each stage, around ``decode_to_host`` and around
each ``next()`` of the compositor."""
from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch

from harness import ref_image, reference, seeded
from harness.clips import audio_frames
from harness.compare import frame_mae_max, rel_gap
from harness.main import Request


def requests(run):
    n = int(run.mix["seconds"] * run.model["float"]["sampling_rate"])
    for i in itertools.count():
        yield Request(i, {"seed": seeded.sub_seed(run.seed, 2, i),
                          "samples": n})


def inputs(run, params):
    """(scene uint8 (H, W, 3), wave (1, N) on the device, sampler seed of
    each face)."""
    s = params["seed"]
    sc = run.model["scene"]
    return (seeded.scene(seeded.sub_seed(s, 0), sc["height"], sc["width"]),
            seeded.wave(seeded.sub_seed(s, 1), params["samples"], run.device),
            [seeded.sub_seed(s, 2, k) for k in range(len(sc["boxes"]))])


def warm(run):
    """The window's shapes: one scene on each path the run takes."""
    n = int(run.mix["seconds"] * run.model["float"]["sampling_rate"])
    for k, staged in enumerate((False, True) if run.traced else (False,)):
        serve(run, Request(-1, {"seed": seeded.sub_seed(run.seed, 3, k),
                                "samples": n}), staged)
    run.spans.clear()


def serve(run, req, staged=False):
    from float_torch.image import composite
    from float_torch.image.face_align import face_align_crop
    scene, wave, seeds = inputs(run, req.params)
    pipe, i = run.pipe, req.index
    sc = run.model["scene"]
    h = sc["height"]
    t = audio_frames(run, wave.shape[-1])

    def det(im):
        k = im.shape[0] / h
        return [(x1 * k, y1 * k, x2 * k, y2 * k, s)
                for x1, y1, x2, y2, s in sc["boxes"]]

    def span(name):
        return run.span(name, i) if staged else contextlib.nullcontext()

    run.sync()
    req.t0 = time.perf_counter()
    faces, motions = [], []
    for idx in range(1, len(sc["boxes"]) + 1):
        crop, bbox = face_align_crop(scene, pipe.cfg.input_size,
                                     margin=sc["margin"], index=idx,
                                     detector=det)
        model_in = torch.from_numpy(
            (crop.astype(np.float32) / 127.5 - 1.0)
            .transpose(2, 0, 1)[None].copy()).to(pipe.device)
        with span("encode_image"):
            s_r, _lam, feats, r_s = pipe.encode_image(model_in)
        with span("encode_audio"):
            wa = pipe.encode_audio(wave, t)
        with span("emotion_latent"):
            we = pipe.emotion_latent(wave, run.model["emotion"])
        with span("sample"):
            r_d = pipe.sample(r_s, wa, we, seed=seeds[idx - 1])
        with span("decode_to_host"):
            faces.append((pipe.decode_to_host(s_r, feats, r_d), bbox))
        motions.append(r_d)
    frames = [] if run.keeps(i) else None
    stream = composite.composite_faces_stream(scene, faces)
    while True:
        with span("composite"):
            fr = next(stream, None)
        if fr is None:
            break
        if fr.shape != scene.shape or fr.dtype != np.uint8:
            raise RuntimeError(f"composited frame {fr.shape} {fr.dtype}")
        req.frames += 1
        if frames is not None:
            frames.append(fr)
    if req.frames != t:
        raise RuntimeError(f"{req.frames} composited frames, expected {t}")
    req.t1 = time.perf_counter()
    if frames is not None:
        run.keep(i, {"motion": motions, "scene": frames})


def expected(run, req, prec):
    """The reference's motion latents of each face and scene frames."""
    scene, wave, seeds = inputs(run, req.params)
    sc = run.model["scene"]
    size = run.model["float"]["input_size"]
    faces, motions = [], []
    for box, seed in zip(sc["boxes"], seeds):
        crop, bbox = ref_image.face_crop(scene, box[:4], size, sc["margin"])
        img = torch.from_numpy(crop.astype(np.float32) / 127.5 - 1.0).permute(
            2, 0, 1)[None].to(run.device)
        r_d, frames = reference.generate(run.ref_params(), img, wave, seed,
                                         run.model, prec)
        motions.append(r_d)
        # the uint8 wire of decode_to_host
        faces.append((torch.round(frames * 255.0) / 255.0, bbox))
    return {"motion": motions,
            "scene": ref_image.composite(scene, faces, run.device)}


def numbers(run, req, got, want) -> dict:
    """The motion latents' relative gap, face by face, and the scene
    frames' gap; ``got["scene"]`` the program's frames, or the control's
    (T, H, W, 3) uint8 on the device."""
    scene = got["scene"]
    if isinstance(scene, list):
        scene = torch.from_numpy(np.stack(scene)).to(run.device)
    scene = scene.float() / 255.0
    return {"motion_rel_max": max(rel_gap(g, w) for g, w in
                                  zip(got["motion"], want["motion"])),
            "scene_mae_max": frame_mae_max(
                scene, want["scene"].float() / 255.0)}
