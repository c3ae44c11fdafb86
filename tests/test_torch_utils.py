"""float_torch.utils against float_tpu.utils: the analytic FLOP counts are
equal count for count (the TPU's mxu/vpu keys renamed matmul/other, the
MFU taken against the H100's dense BF16 peak); the parameter counts of the
port's pipeline equal float_tpu's over its pytree (config 1 counted from
shapes only: a meta-device skeleton on one side, shape structs on the
other); the ProgressCallback case of tests/test_workflow.py; the
logger.  The span recorder of utils/profiling.py: test_torch_tracing.py."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import pytest

from float_tpu import config as j_config
from float_tpu.models import init as j_init
from float_tpu.utils import flops as j_flops
from float_tpu.utils import inspect as j_inspect
from float_torch import config as t_config
from float_torch.models import init as t_init
from float_torch.runtime.pipeline import build_synthetic_pipeline
from float_torch.utils import flops as t_flops
from float_torch.utils import inspect as t_inspect
from float_torch.utils.logging import get_logger, initialize_logger
from float_torch.utils.profiling import ProgressCallback
from torch_parity import TINY, TINY_SER, TINY_W2V

PT = {"config1": t_config.FloatConfig(),
      "tiny": t_config.FloatConfig(**dataclasses.asdict(TINY))}
JX = {"config1": j_config.FloatConfig(), "tiny": TINY}
PT_W2V = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_W2V))
PT_SER = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_SER))


@pytest.mark.parametrize("size", [64, 128, 256, 512])
def test_synthesis_flops_equal(size):
    want = j_flops.synthesis_flops_per_level(size)
    assert t_flops.synthesis_flops_per_level(size) == want
    f, g = j_flops.synthesis_flops_per_frame(size), \
        t_flops.synthesis_flops_per_frame(size)
    assert g == {"matmul_flops": f["mxu_flops"], "other_flops": f["vpu_flops"],
                 "total_flops": f["total_flops"]}


@pytest.mark.parametrize("name", ["config1", "tiny"])
@pytest.mark.parametrize("method", ["euler", "rk4", "heun3"])
def test_fmt_and_sampling_flops_equal(name, method):
    pt, jx = PT[name].replace(ode_method=method), \
        JX[name].replace(ode_method=method)
    for cfg_batch in (1, 3, 4):
        assert t_flops.fmt_flops_per_forward(pt, cfg_batch) == \
            j_flops.fmt_flops_per_forward(jx, cfg_batch)
    for t_frames in (1, 25, 250, 251):
        assert t_flops.sampling_flops_per_clip(t_frames, pt) == \
            j_flops.sampling_flops_per_clip(t_frames, jx)


def test_decode_mfu_uses_the_h100_peak():
    assert t_flops.H100_BF16_PEAK_FLOPS == 989.4e12
    for fps, size in ((309.3, 512), (100.0, 256)):
        j = j_flops.decode_mfu(fps, size)
        t = t_flops.decode_mfu(fps, size)
        assert t["gflop_per_frame_matmul"] == j["gflop_per_frame_mxu"]
        assert t["gflop_per_frame_other"] == j["gflop_per_frame_vpu"]
        assert t["achieved_tflops"] == j["achieved_tflops"]
        mm = t_flops.synthesis_flops_per_frame(size)["matmul_flops"]
        assert t["mfu"] == round(mm * fps / 989.4e12, 4)
        # the same work against the other peak
        assert j_flops.decode_mfu(fps, size, peak=989.4e12)["mfu"] == t["mfu"]


def _jax_shapes(cfg, w2v, ser):
    """float_tpu's param pytree at ``cfg`` as shape structs: its
    initialiser's draws replaced by jax.ShapeDtypeStruct (no memory)."""
    struct = lambda self, *shape, **kw: jax.ShapeDtypeStruct(  # noqa: E731
        shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("t", "zeros", "ones"):
            mp.setattr(j_init._Init, name, struct)
        n_proj = (w2v.hidden_size if cfg.only_last_features
                  else w2v.num_hidden_layers * w2v.hidden_size)
        return {
            "encoder": j_init.init_encoder(cfg.input_size, cfg.dim_w,
                                           cfg.dim_m, 0),
            "synthesis": j_init.init_synthesis(cfg.input_size, cfg.dim_w,
                                               cfg.dim_m, 1),
            "audio_encoder": {
                "wav2vec2": j_init.init_wav2vec2(w2v, 2),
                "audio_projection": j_init.init_audio_projection(
                    n_proj, cfg.dim_w, 3)},
            "emotion": j_init.init_wav2vec2(ser, 4),
            "fmt": j_init.init_fmt(cfg, 5)}


def test_count_params_config1_from_shapes():
    """617.5 M parameters at the published widths, on both sides; every
    subtree's count and the architecture table equal."""
    skel = t_init.empty_pipeline(PT["config1"], t_config.WAV2VEC2_BASE,
                                 t_config.WAV2VEC2_LARGE_SER, device="meta")
    tree = _jax_shapes(JX["config1"], j_config.WAV2VEC2_BASE,
                       j_config.WAV2VEC2_LARGE_SER)
    n = t_inspect.count_params(skel)
    assert n == j_inspect.count_params(tree) == 617_459_962
    assert t_inspect.num2str(n) == "617.46 M"
    for key in tree:
        assert t_inspect.count_params(skel[key]) == \
            j_inspect.count_params(tree[key])
    for depth in (0, 1, -1):
        assert t_inspect.architecture_table(skel, depth) == \
            j_inspect.architecture_table(tree, depth)
    assert t_inspect.count_params(skel.state_dict()) == n


def test_count_params_tiny_pipeline():
    """The port's tiny pipeline (module and state_dict) against
    float_tpu's shape tree at the same configs."""
    pipe = build_synthetic_pipeline(PT["tiny"], PT_W2V, PT_SER, device="cpu")
    tree = _jax_shapes(TINY, TINY_W2V, TINY_SER)
    assert t_inspect.count_params(pipe.params) == \
        j_inspect.count_params(tree) == \
        sum(p.numel() for p in pipe.params.parameters())
    assert t_inspect.architecture_table(pipe.params) == \
        j_inspect.architecture_table(tree)
    table = t_inspect.architecture_table(pipe.params)
    assert "TOTAL" in table and "fmt" in table


@pytest.mark.parametrize("num, want", [(1_500_000, "1.50 M"), (2_500, "2.50 K"),
                                       (999, "999"), (0, "N/A")])
def test_num2str(num, want):
    assert t_inspect.num2str(num) == want == j_inspect.num2str(num)


def test_progress_callback():
    seen = []
    pb = ProgressCallback(5, on_update=lambda d, t: seen.append((d, t)))
    for _ in range(5):
        pb.update()
    assert seen[-1] == (5, 5)
    ProgressCallback(2).update(2)


def test_logger(monkeypatch):
    monkeypatch.setenv("FLOAT_TORCH_DEBUG", "1")
    root = logging.getLogger("float_torch")
    saved = list(root.handlers), root.level
    root.handlers.clear()
    try:
        log = initialize_logger()
        assert log.name == "float_torch" and log.level == logging.INFO
        assert initialize_logger() is log and len(log.handlers) == 1
        assert get_logger("serve").name == "float_torch.serve"
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
