"""float_torch.config is the port's own copy of float_tpu.config (same
fields, defaults, constants and validation); the port imports neither JAX
nor float_tpu; its entry points run on the CUDA device unless told
otherwise."""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import float_tpu.config as J
import float_torch.config as T
from float_torch.runtime.pipeline import FloatPipeline, build_synthetic_pipeline
from torch_parity import TINY, TINY_SER, TINY_W2V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANTS = ("EMOTION_LABELS", "EMOTIONS_UI", "ODE_SOLVERS", "CHANNELS_MAP",
             "RGBA_STRATEGIES", "ADV_KEY_MAP", "WAV2VEC2_BASE",
             "WAV2VEC2_LARGE_SER")


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["FloatConfig", "Wav2Vec2Config"])
def test_dataclass_fields_and_defaults(name):
    t_cls, j_cls = getattr(T, name), getattr(J, name)
    assert t_cls.__module__ == "float_torch.config"
    assert _fields(t_cls) == _fields(j_cls)
    assert dataclasses.asdict(t_cls()) == dataclasses.asdict(j_cls())
    assert t_cls.__dataclass_params__.frozen


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants(name):
    t, j = getattr(T, name), getattr(J, name)
    if dataclasses.is_dataclass(t):
        t, j = dataclasses.asdict(t), dataclasses.asdict(j)
    assert t == j


def test_derived_properties():
    for kw in ({}, {"input_size": 256, "fps": 30.0, "wav2vec_sec": 1.5}):
        t, j = T.FloatConfig(**kw), J.FloatConfig(**kw)
        for prop in ("num_frames_for_clip", "num_total_frames", "n_latent"):
            assert getattr(t, prop) == getattr(j, prop)
    assert T.WAV2VEC2_LARGE_SER.head_dim == J.WAV2VEC2_LARGE_SER.head_dim


@pytest.mark.parametrize("bad", [
    {"ode_method": "dopri5"}, {"rgba_conversion": "keep"},
    {"input_size": 100}, {"dim_h": 1000, "num_heads": 7}])
def test_validate_refuses_like_float_tpu(bad):
    with pytest.raises(ValueError):
        J.FloatConfig(**bad).validate()
    with pytest.raises(ValueError):
        T.FloatConfig(**bad).validate()
    assert T.FloatConfig().validate() == T.FloatConfig()


def test_apply_adv_options():
    adv = {"nfe": 4, "torchdiffeq_ode_method": "rk4", "face_margin": 1.2}
    got = T.apply_adv_options(T.FloatConfig(), adv)
    want = J.apply_adv_options(J.FloatConfig(), adv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert T.apply_adv_options(T.FloatConfig(), None) == T.FloatConfig()
    with pytest.raises(KeyError):
        T.apply_adv_options(T.FloatConfig(), {"steps": 3})


def test_port_imports_no_jax_and_no_float_tpu():
    """Import every module of float_torch in a fresh interpreter."""
    code = (
        "import pkgutil, sys, importlib, float_torch\n"
        "for m in pkgutil.walk_packages(float_torch.__path__, "
        "'float_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'float_tpu'))\n"
        "assert 'float_torch.runtime.pipeline' in sys.modules\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card():
    """With no device= the pipeline is built on CUDA; without a card that
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER)
    from float_torch.models.init import init_pipeline
    params = init_pipeline(TINY, TINY_W2V, TINY_SER, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FloatPipeline(params, TINY, TINY_W2V, TINY_SER)
    pipe = FloatPipeline(params, TINY, TINY_W2V, TINY_SER, device="cpu")
    assert pipe.device.type == "cpu"
