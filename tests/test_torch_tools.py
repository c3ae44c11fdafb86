"""The port's tools (``float_torch/tools``) and the two ``ops`` exports they
complete, against the reference's ``tools/`` scripts and ``float_tpu.ops``
on the CPU at tiny widths (tests/test_pipeline.py's TINY configs, 32
channels at every image level), and the committed full-width fixture's
metadata against the port's config 1 and bench.py's inputs.

Tolerances: ``compare``'s verdicts and the tools' files and counts are
exact; the recorder's stages are held by ``parity_check``'s own
TOLERANCES; ``blur`` and ``grid_sample_bilinear`` to 1e-6 (f32 sums in
another order: cuDNN-free CPU convolutions against XLA's)."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float_tpu.ops as jops
from float_tpu.models import init as j_init
from float_torch import ops as tops
from float_torch.config import EMOTION_LABELS, FloatConfig
from float_torch.io.checkpoint import (load_safetensors, save_safetensors,
                                       unified_state_dict)
from float_torch.models import init as t_init
from float_torch.runtime import pipeline as tp
from float_torch.tools import (check_versions, extract_parts,
                               parity_check as pc, readiness_check as rc,
                               save_combined)
from test_torch_fullwidth import FIXTURE, N_SAMPLES, record
from torch_parity import TINY, TINY_SER, TINY_W2V, max_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name: str):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    """fn's result and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from torch's thread pool, whose spinning
    threads oversubscribe the CPU under the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def narrow():
    """32 channels at every image level on both sides while weights are
    drawn (tests/test_torch_serving.py's narrowing), so the recorder's
    float64 decode stays cheap."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (t_init, j_init):
            mp.setattr(mod, "CHANNELS_MAP",
                       dict.fromkeys(mod.CHANNELS_MAP, 32))
        yield


@pytest.fixture(scope="module")
def recorded(narrow):
    """float_tpu's stages at TINY recorded as for the fixture, and a port
    pipeline of the same weights."""
    acts = record(TINY, TINY_W2V, TINY_SER, 16000, (0, -1))
    return acts, tp.build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER,
                                             device="cpu")


# ---------------------------------------------------------------------------
# parity_check.compare: the reference's verdicts
# ---------------------------------------------------------------------------

def _compare_cases():
    rng = np.random.default_rng(3)
    ref = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    floor = np.full_like(ref, 1e-2)
    return {
        "pass": (ref + 1e-3, ref, None),
        "fail": (ref + 0.1, ref, None),
        "pass_by_floor": (ref + 0.035, ref, floor),
        "fail_by_floor": (ref + 0.06, ref, floor),
        "shape_mismatch": (ref[:1], ref, None),
    }


@pytest.mark.parametrize("case", list(_compare_cases()))
def test_compare_verdict_equals_reference(case):
    got, ref, floor = _compare_cases()[case]
    want = _quiet(_reference("parity_check").compare, case, got, ref,
                  2e-2, 2e-2, floor=floor)[0]
    res, printed = _quiet(pc.compare, case, torch.from_numpy(got), ref,
                          2e-2, 2e-2, floor=floor)
    assert res.ok == want == case.startswith("pass")
    assert printed.startswith("PASS" if want else "FAIL")
    if floor is not None:
        # the per-frame floors the fixture stores give the same verdict
        per_frame = np.abs(floor).reshape(len(floor), -1).max(axis=1)
        assert _quiet(pc.compare, case, got, ref, 2e-2, 2e-2,
                      floor=per_frame)[0].ok == want
        assert res.floor == pytest.approx(1e-2)


def test_compare_storage_slack():
    """The float16 storage rounding widens both budgets, and only by
    itself."""
    ref = np.full((1, 4), 0.5, np.float32)
    assert not _quiet(pc.compare, "x", ref + 0.0301, ref, 2e-2, 2e-2)[0].ok
    res, printed = _quiet(pc.compare, "x", ref + 0.0301, ref, 2e-2, 2e-2,
                          slack=2e-4)
    assert res.ok and "float16 storage" in printed


# ---------------------------------------------------------------------------
# the recorder at TINY, then run_parity on the CPU
# ---------------------------------------------------------------------------

def test_run_parity_passes_every_stage(recorded):
    acts, pipe = recorded
    results = _quiet(pc.run_parity, pipe, acts)[0]
    assert [r.name for r in results] == [
        "s_r", "r_s_lambda", "r_s", "wa", "we", "r_d", "r_d_dyn", "frames",
        "frames_small"]
    assert all(r.ok for r in results), results
    frames = {r.name: r for r in results if r.name.startswith("frames")}
    assert all(r.floor is not None and r.slack > 0 for r in frames.values())


def test_run_parity_scaled_synthesis_weight_fails_the_frames(recorded):
    """The last ToRGB weight of the port's decode scaled by 1.1 fails both
    frame stages and no other.  (These tiny frames lie near 0.5, and a
    1.01 scale of one synthesis weight stays inside the reference's 2e-2
    budget, so this control scales by 1.1.)"""
    acts, pipe = recorded
    weight = pipe.syn_cast["to_rgbs"]["3"]["conv"]["0"]["weight"]
    saved = weight.detach().clone()
    try:
        weight.data.mul_(1.1)
        results = _quiet(pc.run_parity, pipe, acts)[0]
    finally:
        weight.data.copy_(saved)
    failed = sorted(r.name for r in results if not r.ok)
    assert failed == ["frames", "frames_small"]


@pytest.mark.parametrize("what", ["weights", "config", "inputs"])
def test_run_parity_refuses_other_weights_or_inputs(recorded, narrow, what):
    acts, pipe = recorded
    acts = dict(acts)
    if what == "weights":
        pipe = tp.build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER, seed=1,
                                           device="cpu")
    else:
        meta = pc.fixture_meta(acts)
        if what == "config":
            meta["config"]["nfe"] += 1
        else:
            meta["n_samples"] -= 1
        acts["meta"] = np.array(json.dumps(meta))
    with pytest.raises(pc.FixtureMismatch, match="other weights or inputs"):
        pc.run_parity(pipe, acts)


@pytest.mark.parametrize("key", ["noise", "r_d_small", "frames_floor"])
def test_run_parity_refuses_a_recording_without_a_stage(recorded, key):
    acts, pipe = recorded
    acts = {k: v for k, v in acts.items() if k != key}
    with pytest.raises(pc.FixtureMismatch, match=f"lacks.*{key}"):
        pc.run_parity(pipe, acts)


# ---------------------------------------------------------------------------
# readiness_check.gate_load over the three layouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(recorded, tmp_path_factory):
    """A tiny unified file of the recorded weights, and extract_parts
    --all of it with config.json in its two audio folders."""
    _acts, pipe = recorded
    root = tmp_path_factory.mktemp("store")
    unified = str(root / "FLOAT.safetensors")
    save_safetensors(unified_state_dict(pipe.params.state_dict()), unified)
    parts = str(root / "parts")
    assert extract_parts.extract_all(unified, parts)
    for part, cfg, labels in (("wav2vec2_base", TINY_W2V, ()),
                              ("emotion_ser", TINY_SER, EMOTION_LABELS)):
        raw = dataclasses.asdict(cfg)
        if labels:
            raw["id2label"] = {str(i): lbl for i, lbl in enumerate(labels)}
        with open(os.path.join(rc.hf_folder(parts, part), "config.json"),
                  "w") as f:
            json.dump(raw, f)
    return unified, parts


def _part_lines(printed: str) -> list:
    return [ln for ln in printed.splitlines()
            if re.match(r"\[load\]   \w+: [\d.]+ M$", ln)]


@pytest.mark.parametrize("layout", rc.LAYOUTS)
def test_gate_load_counts_equal_reference(store, layout):
    unified, parts = store
    want_params, want_printed = _quiet(_reference("readiness_check")
                                       .gate_load, unified)
    from float_tpu.io.checkpoint import load_safetensors as j_load
    from float_tpu.io.checkpoint import split_unified as j_split
    want_counts = {k: sum(v.size for v in part.values())
                   for k, part in j_split(j_load(unified)).items()}
    (params, counts), printed = _quiet(
        rc.gate_load, unified if layout == "unified" else parts, layout)
    assert counts == want_counts
    assert _part_lines(printed) == _part_lines(want_printed)
    assert printed.rstrip().endswith("[load] ok")
    assert rc.same_params(params, want_params)


def test_gate_layouts_and_readiness_main(store, capsys):
    unified, parts = store
    rc.main(["--checkpoint", unified, "--parts", parts])
    out = capsys.readouterr().out
    assert "[load] parts: every tensor equal" in out
    assert "[load] hf: every tensor equal" in out
    assert out.rstrip().endswith("READY")


def test_gate_parity_on_a_pipeline(recorded, tmp_path):
    """The parity gate runs on the pipeline it is given and returns every
    stage; a recording of other inputs stops it, naming the gate."""
    acts, pipe = recorded
    path = str(tmp_path / "acts.npz")
    np.savez(path, **acts)
    results = _quiet(rc.gate_parity, path, pipe)[0]
    assert len(results) == 9 and all(r.ok for r in results)
    meta = pc.fixture_meta(acts)
    meta["input_seed"] += 1
    np.savez(path, **dict(acts, meta=np.array(json.dumps(meta))))
    with pytest.raises(SystemExit, match=r"\[parity\] FAIL"):
        _quiet(rc.gate_parity, path, pipe)


# ---------------------------------------------------------------------------
# extract_parts / save_combined against the reference tools
# ---------------------------------------------------------------------------

def _run(argv_main, argv):
    with pytest.raises(SystemExit) as exc, \
            contextlib.redirect_stdout(io.StringIO()):
        argv_main(argv)
    return exc.value.code


def test_extract_and_combine_equal_reference_tools(store, tmp_path):
    """extract parts -> save_combined, by the port's tools and by the
    reference's (tests/test_api.py's round trip): the same files, tensor
    for tensor, and the unified file back."""
    unified, _parts = store
    files = {}
    for side in ("port", "reference"):
        out = tmp_path / side
        if side == "port":
            assert _run(extract_parts.main,
                        [unified, "--all", "-o", str(out / "parts")]) == 0
        else:
            subprocess.run([sys.executable, "tools/extract_parts.py", unified,
                            "--all", "-o", str(out / "parts")], cwd=REPO,
                           check=True, capture_output=True)
        args = ["-o", str(out / "combined.safetensors")]
        for arg, key in save_combined.ARGS_TO_KEYS.items():
            args += [f"--{arg}", str(out / "parts"
                                     / extract_parts.DEFAULT_NAMES[key])]
        if side == "port":
            save_combined.main(args)
        else:
            subprocess.run([sys.executable, "tools/save_combined.py", *args],
                           cwd=REPO, check=True, capture_output=True)
        files[side] = out
    for rel in [*extract_parts.DEFAULT_NAMES.values(), "combined.safetensors"]:
        got = load_safetensors(str(files["port"] / "parts" / rel)
                               if rel != "combined.safetensors"
                               else str(files["port"] / rel))
        want = load_safetensors(str(files["reference"] / "parts" / rel)
                                if rel != "combined.safetensors"
                                else str(files["reference"] / rel))
        assert sorted(got) == sorted(want), rel
        assert all(np.array_equal(got[k], want[k]) for k in want), rel
    orig = load_safetensors(unified)
    back = load_safetensors(str(files["port"] / "combined.safetensors"))
    assert sorted(back) == sorted(orig)
    assert all(np.array_equal(back[k], orig[k]) for k in orig)


def test_extract_single_part_and_missing_part(store, tmp_path):
    unified, _parts = store
    out = str(tmp_path / "fmt.safetensors")
    assert _run(extract_parts.main, [unified, "--part", "fmt", "-o", out]) == 0
    fmt = load_safetensors(out)
    assert fmt and all(
        np.array_equal(v, load_safetensors(unified)[f"fmt.{k}"])
        for k, v in fmt.items())
    empty = str(tmp_path / "empty.safetensors")
    save_safetensors({"other.weight": np.zeros(2, np.float32)}, empty)
    assert _run(extract_parts.main,
                [empty, "--part", "fmt", "-o", str(tmp_path / "x")]) == 1


# ---------------------------------------------------------------------------
# check_versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", [None, "9.9.9"])
def test_check_versions(tmp_path, monkeypatch, capsys, version):
    """Passes on the repository; fails on a copied pyproject.toml that
    names another version."""
    if version is not None:
        with open(os.path.join(REPO, "pyproject.toml")) as f:
            text = f.read()
        (tmp_path / "pyproject.toml").write_text(
            re.sub(r'(?m)^version\s*=\s*"[^"]+"', f'version = "{version}"',
                   text))
        (tmp_path / "float_torch").mkdir()
        shutil.copy(os.path.join(REPO, "float_torch", "__init__.py"),
                    tmp_path / "float_torch")
        monkeypatch.setattr(check_versions, "ROOT", str(tmp_path))
        with pytest.raises(SystemExit) as exc:
            check_versions.main()
        assert exc.value.code == 1
        assert "version mismatch" in capsys.readouterr().out
    else:
        check_versions.main()
        assert "versions consistent" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# ops: blur and grid_sample_bilinear against float_tpu.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,pad", [((1, 3, 16, 16), (2, 1)),
                                       ((2, 8, 12, 20), (1, 1)),
                                       ((1, 4, 9, 9), (-1, 2))])
def test_blur_matches_float_tpu(shape, pad):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    want = jops.blur(jnp.asarray(x), jops.make_blur_kernel((1, 3, 3, 1)), pad)
    got = tops.blur(torch.from_numpy(x), tops.make_blur_kernel((1, 3, 3, 1)),
                    pad)
    assert tuple(got.shape) == want.shape and max_err(got, want) <= 1e-6


@pytest.mark.parametrize("b,c,h,w,ho,wo", [
    (2, 8, 16, 16, 16, 16),      # the map's own resolution: K3's shape
    (1, 3, 20, 12, 7, 9),        # smaller output
    (3, 5, 8, 8, 16, 16),        # larger output
    (1, 4, 32, 32, 32, 32)])
def test_grid_sample_bilinear_matches_float_tpu(b, c, h, w, ho, wo):
    rng = np.random.default_rng(b * 100 + ho)
    feat = rng.standard_normal((b, c, h, w)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (b, ho, wo, 2)).astype(np.float32)
    want = jops.grid_sample_bilinear(jnp.asarray(feat), jnp.asarray(grid))
    got = tops.grid_sample_bilinear(torch.from_numpy(feat),
                                    torch.from_numpy(grid))
    assert tuple(got.shape) == want.shape == (b, c, ho, wo)
    assert max_err(got, want) <= 1e-6
    # on the CPU the dispatcher is its plain version, at every shape
    assert torch.equal(got, tops.grid_sample_bilinear_ref(
        torch.from_numpy(feat), torch.from_numpy(grid)))


def test_grid_sample_bilinear_dispatch_rule():
    """K3 takes a bf16 or f32 map of any C sampled at its own resolution,
    which covers the reference's ``supports``; another output size or
    dtype runs the plain version (the reference's Pallas-where-supports
    rule)."""
    from float_torch.ops.warp import _k3_supports
    f32 = torch.zeros(2, 8, 16, 16)
    assert _k3_supports(f32, torch.zeros(2, 16, 16, 2))
    assert _k3_supports(f32.bfloat16(), torch.zeros(2, 16, 16, 2))
    assert _k3_supports(torch.zeros(2, 3, 16, 16, dtype=torch.bfloat16),
                        torch.zeros(2, 16, 16, 2))
    assert not _k3_supports(f32, torch.zeros(2, 8, 16, 2))
    assert not _k3_supports(f32.half(), torch.zeros(2, 16, 16, 2))
    with pytest.raises(ValueError):
        tops.grid_sample_bilinear(f32, torch.zeros(3, 16, 16, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("c,size,dtype", [
    (8, 32, torch.float32),
    (3, 256, torch.bfloat16),    # an RGB image, which the TPU kernel takes
    (5, 32, torch.float32)])
def test_grid_sample_bilinear_goes_through_k3_on_the_card(c, size, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from float_torch.kernels import LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(c)
    feat = torch.randn(2, c, size, size, device="cuda",
                       generator=gen).to(dtype)
    # bf16: one step of the output's rounding, 2^-7 of max|feat| (the
    # kernels' test tolerance); f32 sums agree to the last bits
    tol = 2.0 ** -7 * feat.float().abs().max().item() \
        if dtype == torch.bfloat16 else 1e-6
    for ho, launched in ((size, 1), (size // 2 + 1, 0)):
        grid = torch.rand(2, ho, ho, 2, device="cuda", generator=gen) * 2 - 1
        LAUNCHES.clear()
        got = tops.grid_sample_bilinear(feat, grid)
        assert LAUNCHES["warp_per_frame"] == launched
        assert got.dtype == dtype and tuple(got.shape) == (2, c, ho, ho)
        want = tops.grid_sample_bilinear_ref(feat.cpu(), grid.cpu())
        assert max_err(got, want) <= tol


# ---------------------------------------------------------------------------
# the committed full-width fixture
# ---------------------------------------------------------------------------

def test_fixture_metadata_agrees_with_config1_and_bench_inputs():
    assert os.path.getsize(FIXTURE) <= 8e6
    acts = dict(np.load(FIXTURE))
    meta = pc.fixture_meta(acts)
    cfg = FloatConfig(compute_dtype="float32")
    from float_torch.config import WAV2VEC2_BASE, WAV2VEC2_LARGE_SER
    assert meta["config"] == pc.config_fields(cfg)
    assert meta["wav2vec2"] == pc.wav2vec2_fields(WAV2VEC2_BASE)
    assert meta["ser"] == pc.wav2vec2_fields(WAV2VEC2_LARGE_SER)
    assert (meta["weights_seed"], meta["input_seed"], meta["image_size"],
            meta["n_samples"]) == (0, 0, 512, N_SAMPLES)
    # bench.py draws its inputs so: default_rng(0), the image, then audio
    with open(os.path.join(REPO, "bench.py")) as f:
        bench = f.read()
    for expr in ("rng = np.random.default_rng(0)", "n_samples = 160000",
                 "rng.standard_normal((1, 3, 512, 512)).astype(np.float32)"
                 " * 0.3",
                 "rng.standard_normal((1, n_samples)).astype(np.float32)"
                 " * 0.1"):
        assert expr in bench, expr
    img, wave = pc.bench_inputs(0, 512, N_SAMPLES)
    assert meta["inputs_sha256"] == pc.inputs_checksum(img, wave)
    assert set(meta["weights_sha256"]) == {
        "encoder", "synthesis", "audio_encoder", "emotion", "fmt"}
    t = tp.audio_num_frames(N_SAMPLES, cfg)
    n_chunks = -(-t // cfg.num_frames_for_clip)
    frame = (cfg.input_size, cfg.input_size, 3)
    shapes = {
        "s_r": (1, cfg.dim_w), "r_s_lambda": (1, cfg.dim_m),
        "r_s": (1, cfg.dim_w), "wa": (1, t, cfg.dim_w),
        "we": (1, 1, cfg.dim_e),
        "noise": (n_chunks, 1, cfg.num_frames_for_clip, cfg.dim_w),
        "r_d": (1, t, cfg.dim_w), "we_dyn": (1, t, cfg.dim_e),
        "noise_dyn": (n_chunks, 1, cfg.num_frames_for_clip, cfg.dim_w),
        "r_d_dyn": (1, t, cfg.dim_w), "r_d_frames": (1, 2, cfg.dim_w),
        "r_d_small": (1, 2, cfg.dim_w), "frames": (2, *frame),
        "frames_floor": (2,), "frames_small": (2, *frame),
        "frames_small_floor": (2,)}
    assert sorted(acts) == sorted([*shapes, "meta"])
    for key, shape in shapes.items():
        assert acts[key].shape == shape, key
        assert acts[key].dtype == (np.float16 if key in (
            "frames", "frames_small") else np.float32), key
    assert meta["frame_index"] == [0, t - 1]
    np.testing.assert_array_equal(acts["r_d_frames"],
                                  acts["r_d"][:, meta["frame_index"]])
