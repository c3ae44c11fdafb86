"""Numeric parity of the port, stage by stage, against activations
recorded from ``float_tpu`` (twin of tools/parity_check.py):

    python -m float_torch.tools.parity_check tests/fixtures/float_tpu_config1_f32.npz \\
        --checkpoint FLOAT.safetensors [--device cpu]

The activations are recorded from ``float_tpu`` on the CPU in float32 by
``python tests/test_torch_fullwidth.py --record OUT.npz``: the weights of
``build_synthetic_pipeline(seed=0)``, bench.py's inputs (``default_rng(0)``:
a 512² image x0.3, then 160 000 samples x0.1).  The file holds no inputs:
they are drawn again from the seed in its metadata.  Their checksum, the
pipeline's weights (a checksum per part) and the config fields the stages
depend on must be the recording's, or the run stops before any stage with
"other weights or inputs" (exit 2): that is not a parity failure.

Stages (every one must be recorded, with its inputs: ``STAGE_KEYS``):
  s_r, r_s_lambda, r_s   image encoder + Direction
  wa                     wav2vec2-base + interpolation + projection
  we                     SER emotion softmax
  r_d                    chunked CFG-ODE sampling with the recorded noise
  r_d_dyn                the same with a recorded per-frame emotion
  frames_small           decode at trained-regime latent scale (strict)
  frames                 decode at raw x0 scale — judged relative to the
                         reference's own f32-vs-f64 conditioning floor,
                         since random weights + unit-variance latents make
                         the synthesis chaotically conditioned

The decode stages run from the RECORDED latents, so decode parity is
isolated from sampling drift; the recorded frames of both stages are
decoded in one batch.  Frames stored as float16 add their storage
rounding, 2^-11 of max|frame|, to the budget, and the output says so.
Exit 0 when every stage is within tolerance, else 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

TOLERANCES = {           # fp32 stage tolerances (atol, rtol)
    "s_r": (1e-3, 1e-3),
    "r_s_lambda": (1e-3, 1e-3),
    "r_s": (2e-3, 2e-3),
    "wa": (2e-3, 2e-3),
    "we": (1e-3, 1e-3),
    "r_d": (5e-3, 5e-3),
    "frames_small": (2e-2, 2e-2),
    "frames": (2e-2, 2e-2),
}
FLOOR_FACTOR = 4.0       # frames pass if err <= FLOOR_FACTOR * f32-vs-f64 floor
# float16 keeps 11 significant bits: storing a frame rounds it by at most
# 2^-11 of its magnitude
F16_STORAGE = 2.0 ** -11
# FloatConfig fields the recorded stages depend on: the widths, the audio
# framing, the sampler and the dtypes
CONFIG_FIELDS = (
    "input_size", "input_nc", "fps", "sampling_rate", "wav2vec_sec",
    "attention_window", "only_last_features", "dim_a", "dim_w", "dim_h",
    "dim_m", "dim_e", "fmt_depth", "num_heads", "mlp_ratio",
    "num_prev_frames", "nfe", "ode_method", "r_cfg_scale", "include_r_cfg",
    "ser_max_sec", "compute_dtype", "sampler_dtype")


# the recording's arrays: the stages and the recorded noise, emotion and
# latents they are fed; a fixture missing one is refused before any stage
STAGE_KEYS = ("s_r", "r_s_lambda", "r_s", "wa", "we", "noise", "r_d",
              "we_dyn", "noise_dyn", "r_d_dyn", "r_d_frames", "frames",
              "frames_floor", "r_d_small", "frames_small",
              "frames_small_floor")
# the decode stages and the recorded latents each decodes
DECODE_STAGES = (("frames", "r_d_frames"), ("frames_small", "r_d_small"))


class StageResult(NamedTuple):
    """One stage's verdict.  ``floor`` is the max of the reference's own
    f32-vs-f64 spread (frames only); ``slack`` the storage rounding added to
    the budget."""
    name: str
    ok: bool
    max_err: float
    atol: float
    rtol: float
    floor: Optional[float] = None
    slack: float = 0.0

    @property
    def floor_ratio(self) -> Optional[float]:
        if self.floor is None:
            return None
        return self.max_err / max(self.floor, 1e-12)


class FixtureMismatch(Exception):
    """The pipeline's weights, config or inputs are not the recording's."""


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def compare(name, got, ref, atol, rtol, floor=None,
            slack: float = 0.0) -> StageResult:
    """The reference's verdict: every element within atol + rtol·|ref|;
    failing that, with a ``floor`` (the reference's f32 - f64 frames, or
    their per-frame max|.|), the clip's max error within FLOOR_FACTOR × the
    floor's max (at least atol).  ``slack`` widens both budgets by the
    reference's storage rounding."""
    got, ref = _np(got), _np(ref)
    if got.shape != ref.shape:
        print(f"FAIL {name}: shape {got.shape} != {ref.shape}")
        return StageResult(name, False, float("inf"), atol, rtol)
    err = np.abs(got - ref)
    rel = err / (np.abs(ref) + 1e-6)
    ok = bool((err <= atol + slack + rtol * np.abs(ref)).all())
    note, fl = "", None
    if floor is not None:
        # conditioning floor: ours-vs-ref-f32 must stay within FLOOR_FACTOR
        # of the clip's own ref-f32-vs-ref-f64 spread.  (The comparison is
        # clip-global: per-frame floors fluctuate randomly — a frame where
        # two roundings happen to agree is not evidence that a third must.)
        floor = np.abs(np.asarray(floor, np.float32))
        fl = float(floor.max())
        if not ok:
            ok = float(err.max()) <= max(FLOOR_FACTOR * fl, atol) + slack
        e_t = err.reshape(err.shape[0], -1).max(axis=1)
        f_t = floor.reshape(floor.shape[0], -1).max(axis=1)
        ratio = e_t / np.maximum(f_t, atol / FLOOR_FACTOR)
        note = (f"  [conditioning floor (ref f32-vs-f64): max={fl:.3e}, "
                f"ours/floor={err.max() / max(fl, 1e-12):.2f}x "
                f"(per-frame median {np.median(ratio):.2f}x), "
                f"pass<={FLOOR_FACTOR}x]")
    if slack:
        note += f"  [+{slack:.3e} float16 storage of the reference frames]"
    print(f"{'PASS' if ok else 'FAIL'} {name}: max|err|={err.max():.3e} "
          f"max rel={rel.max():.3e} (atol={atol}, rtol={rtol}){note}")
    return StageResult(name, ok, float(err.max()), atol, rtol, fl, slack)


def weight_checksums(state: Mapping) -> dict:
    """{part: sha256} over a state_dict's float32 tensors (numpy or torch),
    key and bytes in key order, a part being the key's first component."""
    hashes: dict = {}
    for key in sorted(state):
        h = hashes.setdefault(key.split(".", 1)[0], hashlib.sha256())
        h.update(key.encode())
        h.update(_np(state[key]).tobytes())
    return {part: h.hexdigest() for part, h in hashes.items()}


def bench_inputs(seed: int, size: int, n_samples: int):
    """bench.py's inputs: (1, 3, size, size) image x0.3, then (1, n_samples)
    audio x0.1, both drawn from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((1, 3, size, size)).astype(np.float32) * 0.3
    wave = rng.standard_normal((1, n_samples)).astype(np.float32) * 0.1
    return img, wave


def inputs_checksum(img: np.ndarray, wave: np.ndarray) -> str:
    return hashlib.sha256(_np(img).tobytes() + _np(wave).tobytes()).hexdigest()


def _plain(obj) -> dict:
    """JSON round trip: tuples compare equal to the recording's lists."""
    return json.loads(json.dumps(obj))


def config_fields(cfg) -> dict:
    return _plain({k: getattr(cfg, k) for k in CONFIG_FIELDS})


def wav2vec2_fields(cfg) -> dict:
    return _plain(dataclasses.asdict(cfg))


def load_activations(path: str) -> dict:
    return dict(np.load(path))


def fixture_meta(acts: Mapping) -> dict:
    return json.loads(str(acts["meta"]))


def check_fixture(pipe, acts: Mapping):
    """The recording's inputs, drawn again, and its metadata; raises
    FixtureMismatch naming what differs when the pipeline's config,
    weights or the regenerated inputs are not the recording's."""
    missing = [k for k in ("meta", *STAGE_KEYS) if k not in acts]
    if missing:
        raise FixtureMismatch(f"the recording lacks {missing}")
    meta = fixture_meta(acts)
    problems = []
    have = config_fields(pipe.cfg)
    diff = {k: (have.get(k), v) for k, v in meta["config"].items()
            if have.get(k) != v}
    if diff:
        problems.append(f"config fields (ours, recorded) {diff}")
    for name, cfg in (("wav2vec2", pipe.w2v_cfg), ("ser", pipe.ser_cfg)):
        if wav2vec2_fields(cfg) != meta[name]:
            problems.append(f"the {name} tower's config")
    sums = weight_checksums(pipe.params.state_dict())
    bad = sorted(p for p, h in meta["weights_sha256"].items()
                 if sums.get(p) != h)
    if bad or set(sums) != set(meta["weights_sha256"]):
        problems.append(f"the weights of {bad or sorted(sums)}")
    img, wave = bench_inputs(meta["input_seed"], meta["image_size"],
                             meta["n_samples"])
    if inputs_checksum(img, wave) != meta["inputs_sha256"]:
        problems.append("the regenerated inputs")
    if problems:
        raise FixtureMismatch("other weights or inputs than the recording's: "
                              + "; ".join(problems))
    return img, wave, meta


def run_parity(pipe, acts: Mapping) -> list:
    """Every stage of ``pipe`` (a float32 FloatPipeline) against ``acts``;
    prints one line per stage and returns their StageResults.  Raises
    FixtureMismatch before any stage on a recording that lacks a stage, or
    on other weights or inputs."""
    from ..runtime.pipeline import audio_num_frames
    img, wave, meta = check_fixture(pipe, acts)
    results = []
    t_frames = audio_num_frames(wave.shape[-1], pipe.cfg)

    s_r, lam, feats, r_s = pipe.encode_image(img)
    for name, got in (("s_r", s_r), ("r_s_lambda", lam), ("r_s", r_s)):
        results.append(compare(name, got, acts[name], *TOLERANCES[name]))

    wa = pipe.encode_audio(wave, t_frames)
    results.append(compare("wa", wa, acts["wa"], *TOLERANCES["wa"]))

    we = pipe.emotion_latent(wave, meta["emotion"])
    results.append(compare("we", we, acts["we"], *TOLERANCES["we"]))

    # the sampler fed the recorded noise: torch.Generator and jax.random
    # draw other numbers
    scales = dict(a_cfg_scale=meta["a_cfg_scale"],
                  e_cfg_scale=meta["e_cfg_scale"])
    r_d = pipe.sample(r_s, wa, we, noise=acts["noise"], **scales)
    results.append(compare("r_d", r_d, acts["r_d"], *TOLERANCES["r_d"]))
    r_d_dyn = pipe.sample(r_s, wa, pipe._tensor(acts["we_dyn"]),
                          noise=acts["noise_dyn"], **scales)
    results.append(compare("r_d_dyn", r_d_dyn, acts["r_d_dyn"],
                           *TOLERANCES["r_d"]))

    results += decode_stages(pipe, acts, s_r, feats)
    print(f"\n{sum(r.ok for r in results)}/{len(results)} stages within "
          f"tolerance")
    return results


def decode_stages(pipe, acts: Mapping, s_r, feats) -> list:
    """``frames`` and ``frames_small``: ``pipe`` decodes the RECORDED
    latents of both in one batch, from its own encoding ``s_r``, ``feats``
    of the image, so decode parity is isolated from sampling drift (which
    the chaotic random-weight synthesis amplifies)."""
    rows = np.concatenate([acts[lat][0] for _name, lat in DECODE_STAGES])
    frames = pipe.decode(s_r, feats, pipe._tensor(rows))
    results, lo = [], 0
    for name, lat in DECODE_STAGES:
        ref, n = acts[name], len(acts[lat][0])
        slack = (F16_STORAGE * float(np.abs(ref.astype(np.float32)).max())
                 if ref.dtype == np.float16 else 0.0)
        results.append(compare(name, frames[lo:lo + n], ref,
                               *TOLERANCES[name], floor=acts[f"{name}_floor"],
                               slack=slack))
        lo += n
    return results


def float32_pipeline(params, device: str):
    """The parity pipeline: config 1 in float32 (TF32 off on a card, as
    construction sets it)."""
    from ..config import FloatConfig
    from ..runtime.pipeline import FloatPipeline
    return FloatPipeline(params, FloatConfig(compute_dtype="float32"),
                         device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("activations",
                    help=".npz of activations recorded from float_tpu")
    ap.add_argument("--checkpoint", default="models/float/FLOAT.safetensors")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu on a machine "
                         "without a card)")
    args = ap.parse_args(argv)

    from ..io.checkpoint import load_unified_checkpoint
    acts = load_activations(args.activations)
    pipe = float32_pipeline(load_unified_checkpoint(args.checkpoint),
                            args.device)
    try:
        results = run_parity(pipe, acts)
    except FixtureMismatch as exc:
        print(f"MISMATCH: {exc}")
        sys.exit(2)
    sys.exit(0 if all(r.ok for r in results) else 1)


if __name__ == "__main__":
    main()
