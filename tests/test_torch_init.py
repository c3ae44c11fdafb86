"""float_torch.models.init draws float_tpu's synthetic weights bit for bit
without JAX; its trees load into the port's modules with one strict
load_state_dict; the port never imports JAX."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from float_tpu.models import init as j_init
from float_torch.models import init as t_init
from float_torch.runtime.pipeline import FloatPipeline
from torch_parity import TINY, TINY_SER, TINY_W2V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMPONENTS = {
    "encoder": lambda m: m.init_encoder(64, 64, 20, seed=0),
    "synthesis": lambda m: m.init_synthesis(64, 64, 20, seed=1),
    "wav2vec2": lambda m: m.init_wav2vec2(TINY_W2V, seed=2),
    "ser": lambda m: m.init_wav2vec2(TINY_SER, seed=6),
    "audio_projection": lambda m: m.init_audio_projection(64, 64, seed=3),
    "fmt": lambda m: m.init_fmt(TINY, seed=5),
}


@pytest.mark.parametrize("name", sorted(COMPONENTS))
def test_init_bit_identical(name):
    want = COMPONENTS[name](j_init)
    got = COMPONENTS[name](t_init)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_pipeline_params_load_strict():
    params = t_init.init_pipeline(TINY, TINY_W2V, TINY_SER, seed=0)
    sd = t_init.params_to_state_dict(params)
    skeleton = t_init.empty_pipeline(TINY, TINY_W2V, TINY_SER)
    assert sorted(skeleton.state_dict()) == sorted(sd)
    skeleton.load_state_dict(sd, strict=True)
    assert torch.equal(skeleton["synthesis"]["convs"]["0"]["conv"]["weight"],
                       torch.from_numpy(params["synthesis"]["convs"]["0"]
                                        ["conv"]["weight"]))
    assert "fmt.blocks.1.adaLN_modulation.1.weight" in sd
    assert not any(p.requires_grad for p in skeleton.parameters())


def test_pipeline_refuses_incomplete_params():
    params = t_init.init_pipeline(TINY, TINY_W2V, TINY_SER, seed=0)
    del params["fmt"]["decoder"]["linear"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        FloatPipeline(params, TINY, TINY_W2V, TINY_SER)


def test_synthesis_cast_once():
    pipe = FloatPipeline(t_init.init_pipeline(TINY, TINY_W2V, TINY_SER),
                         TINY.replace(compute_dtype="bfloat16"), TINY_W2V,
                         TINY_SER)
    assert {p.dtype for p in pipe.syn_cast.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in pipe.params.parameters()} == {torch.float32}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_never_imports_jax():
    code = ("import sys, float_torch, float_torch.runtime.pipeline, "
            "float_torch.kernels.warp_shared; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
