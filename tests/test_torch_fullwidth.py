"""The port at config 1's widths against ``float_tpu``, and the recorder of
the fixture it is held to.

    python tests/test_torch_fullwidth.py --record OUT.npz

records ``float_tpu``'s stages on the CPU in float32 at config 1's widths
(``build_synthetic_pipeline(FloatConfig(compute_dtype="float32"), seed=0)``,
617.5 M parameters; bench.py's inputs: ``default_rng(0)``, a 512² image
x0.3 and 160 000 samples x0.1): every stage of
``float_torch.tools.parity_check``, with the sampler noise (numpy, fed to
both samplers through ``noise=``), a per-frame emotion for ``r_d_dyn``, and
two frames of the clip decoded at raw and at trained-regime latent scale,
stored as float16, each frame's f32-vs-f64 floor beside it (the f64
decode runs with ``jax_enable_x64`` on, in the recorder alone, with
float_tpu's float32 accumulation lifted to float64 for its duration).  The
committed ``tests/fixtures/float_tpu_config1_f32.npz`` is its output.  The
recorder is test-side code: it imports ``float_tpu`` and JAX, and nothing
in ``float_torch`` imports it.

The two tests below take minutes of CPU at full width and are marked
``slow`` (tier-1 runs ``-m 'not slow'``):
``python -m pytest tests/test_torch_fullwidth.py -m slow``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

INPUT_SEED = 0           # bench.py's inputs
NOISE_SEED = 1           # sampler noise and the per-frame emotion
EMOTION = "none"         # predicted by the SER
A_CFG, E_CFG = 2.0, 1.3  # tools/parity_check.py's sampler scales
SMALL_SCALE = 0.05       # trained-regime latent scale of frames_small
N_SAMPLES = 160_000      # 10 s at 16 kHz
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "float_tpu_config1_f32.npz")


@contextlib.contextmanager
def _float64_accumulation():
    """float_tpu asks its convolutions and einsums for float32 sums
    (``preferred_element_type=jnp.float32``), which float64 operands
    refuse.  For the floor's float64 decode, ``jax.lax.conv_general_dilated``
    and ``jnp.einsum`` are wrapped so that such a request on float64
    operands sums in float64; float_tpu's explicit float32 casts (the
    flows, the masks, the output) stay, so the floor is, if anything, an
    under-estimate."""
    import jax
    import jax.numpy as jnp

    def lift(fn):
        def call(*args, **kw):
            if kw.get("preferred_element_type") == jnp.float32 and any(
                    getattr(a, "dtype", None) == jnp.float64 for a in args):
                kw["preferred_element_type"] = jnp.float64
            return fn(*args, **kw)
        return call

    saved = jax.lax.conv_general_dilated, jnp.einsum
    jax.lax.conv_general_dilated, jnp.einsum = map(lift, saved)
    try:
        yield
    finally:
        jax.lax.conv_general_dilated, jnp.einsum = saved


def record(cfg, w2v, ser, n_samples: int, frame_index,
           seed: int = 0) -> dict:
    """Every stage of ``float_tpu``'s pipeline built with ``seed``'s
    weights on bench.py's inputs, as ``parity_check.run_parity`` reads
    them.  ``frame_index``: the clip's frames to decode (negative counts
    from the end)."""
    import jax
    import jax.numpy as jnp

    from float_tpu.runtime import pipeline as jp
    from float_tpu.runtime.decode import decode_latents
    from float_tpu.runtime.sampling import sample_motion_latents
    from float_torch.models.init import params_to_state_dict
    from float_torch.tools import parity_check as pc

    pipe = jp.build_synthetic_pipeline(cfg, w2v, ser, seed=seed)
    params = pipe.params
    img, wave = pc.bench_inputs(INPUT_SEED, cfg.input_size, n_samples)
    t = jp.audio_num_frames(n_samples, cfg)
    s_r, lam, feats, r_s = pipe.encode_image(jnp.asarray(img))
    wa = pipe.encode_audio(jnp.asarray(wave), t)
    we = pipe.emotion_latent(jnp.asarray(wave), EMOTION)

    clip = cfg.num_frames_for_clip
    rng = np.random.default_rng(NOISE_SEED)
    shape = (math.ceil(t / clip), 1, clip, cfg.dim_w)
    noise = rng.standard_normal(shape).astype(np.float32)
    noise_dyn = rng.standard_normal(shape).astype(np.float32)
    logits = rng.standard_normal((1, t, cfg.dim_e)) * 1.5
    we_dyn = np.exp(logits - logits.max(-1, keepdims=True))
    we_dyn = (we_dyn / we_dyn.sum(-1, keepdims=True)).astype(np.float32)
    sample = jax.jit(partial(sample_motion_latents, cfg=cfg,
                             a_cfg_scale=A_CFG, e_cfg_scale=E_CFG))
    r_d = sample(params["fmt"], r_s, wa, we, noise=jnp.asarray(noise))
    r_d_dyn = sample(params["fmt"], r_s, wa, jnp.asarray(we_dyn),
                     noise=jnp.asarray(noise_dyn))

    idx = [i % t for i in frame_index]
    r_d_frames = np.asarray(r_d)[:, idx]
    r_d_small = (SMALL_SCALE * r_d_frames).astype(np.float32)
    rows = np.concatenate([r_d_frames[0], r_d_small[0]])
    decode = partial(decode_latents, size=cfg.input_size,
                     decode_batch=cfg.decode_batch, use_warp_kernel=False)
    frames = np.asarray(decode(params["synthesis"], s_r, feats,
                               jnp.asarray(rows), compute_dtype=jnp.float32))
    with jax.enable_x64(True), _float64_accumulation():
        f64 = partial(jnp.asarray, dtype=jnp.float64)
        frames64 = np.asarray(decode(
            jax.tree.map(f64, params["synthesis"]), f64(s_r),
            [f64(f) for f in feats], f64(rows), compute_dtype=jnp.float64))
    floor = np.abs(frames - frames64).reshape(len(rows), -1).max(axis=1)
    n = len(idx)

    meta = dict(
        recorder="tests/test_torch_fullwidth.py: float_tpu on the CPU in "
                 "float32; floors from its float64 decode",
        jax=jax.__version__, weights_seed=seed, input_seed=INPUT_SEED,
        noise_seed=NOISE_SEED, image_size=cfg.input_size,
        n_samples=n_samples, emotion=EMOTION, a_cfg_scale=A_CFG,
        e_cfg_scale=E_CFG, small_scale=SMALL_SCALE, frame_index=idx,
        config=pc.config_fields(cfg), wav2vec2=pc.wav2vec2_fields(w2v),
        ser=pc.wav2vec2_fields(ser),
        inputs_sha256=pc.inputs_checksum(img, wave),
        weights_sha256=pc.weight_checksums(params_to_state_dict(params)))
    f32 = partial(np.asarray, dtype=np.float32)
    return dict(
        meta=np.array(json.dumps(meta, sort_keys=True)),
        s_r=f32(s_r), r_s_lambda=f32(lam), r_s=f32(r_s), wa=f32(wa),
        we=f32(we), noise=noise, r_d=f32(r_d), we_dyn=we_dyn,
        noise_dyn=noise_dyn, r_d_dyn=f32(r_d_dyn), r_d_frames=r_d_frames,
        r_d_small=r_d_small,
        frames=frames[:n].astype(np.float16),
        frames_floor=floor[:n].astype(np.float32),
        frames_small=frames[n:].astype(np.float16),
        frames_small_floor=floor[n:].astype(np.float32))


def record_config1(seed: int = 0) -> dict:
    """The fixture: config 1's widths in float32, the first and the last
    frame of the clip."""
    from float_tpu.config import (WAV2VEC2_BASE, WAV2VEC2_LARGE_SER,
                                  FloatConfig)
    return record(FloatConfig(compute_dtype="float32"), WAV2VEC2_BASE,
                  WAV2VEC2_LARGE_SER, N_SAMPLES, (0, -1), seed=seed)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", metavar="OUT.npz", required=True,
                    help="where to write the recording")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    acts = record_config1()
    np.savez_compressed(args.record, **acts)
    print(f"recorded {sorted(acts)} -> {args.record} "
          f"({os.path.getsize(args.record) / 1e6:.2f} MB)")


pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


def test_port_on_cpu_matches_fixture(fixture):
    """The port on the CPU at config 1's widths (seed-0 weights, float32)
    against the fixture: every stage within the reference's TOLERANCES
    (frames by the floor, plus the float16 storage)."""
    from float_torch.config import FloatConfig
    from float_torch.runtime.pipeline import build_synthetic_pipeline
    from float_torch.tools.parity_check import TOLERANCES, run_parity
    pipe = build_synthetic_pipeline(FloatConfig(compute_dtype="float32"),
                                    device="cpu")
    results = run_parity(pipe, fixture)
    names = [r.name for r in results]
    assert names == ["s_r", "r_s_lambda", "r_s", "wa", "we", "r_d",
                     "r_d_dyn", "frames", "frames_small"]
    assert set(names) - {"r_d_dyn"} == set(TOLERANCES)
    assert all(r.ok for r in results), results


def test_fresh_recording_equals_fixture(fixture, tmp_path):
    """The recorder, run again in a process of its own, writes the
    committed fixture: every array and the metadata equal."""
    out = tmp_path / "again.npz"
    subprocess.run([sys.executable, os.path.abspath(__file__), "--record",
                    str(out)], check=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    again = dict(np.load(out))
    assert sorted(again) == sorted(fixture)
    for key, want in fixture.items():
        np.testing.assert_array_equal(again[key], want, err_msg=key)


if __name__ == "__main__":
    main()
