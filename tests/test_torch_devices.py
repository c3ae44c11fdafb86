"""Which CUDA device the port uses: a pipeline keeps an indexed device,
and a kernel launch on one card leaves the caller's current device as it
was.  Imports neither JAX nor float_tpu, so the card test runs on a
machine without them: ``python -m pytest --noconftest -m cuda
tests/test_torch_devices.py``."""
import numpy as np
import pytest
import torch

from float_torch.runtime import pipeline as tp


def test_pipeline_device_is_indexed(monkeypatch):
    """"cuda" becomes the current card's index, so the pipeline's tensors
    stay there whatever device is current later."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert tp._checked_device("cuda") == torch.device("cuda", 1)
    assert tp._checked_device("cuda:0") == torch.device("cuda", 0)
    assert tp._checked_device("cpu") == torch.device("cpu")


@pytest.fixture
def last_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.cuda
def test_launch_keeps_the_callers_device(last_card):
    """K1, K2, K3, K5 and K6 launched on the last card, with card 0
    current: card 0 is still current afterwards, and a following
    device="cuda" allocation lands on it.  (With one card both are card
    0.)"""
    from float_torch.experiments.fma_dtype_bench import make
    from float_torch.experiments.warp_selection_matmul import (
        warp_bilinear_windowed)
    from float_torch.kernels import LAUNCHES
    from float_torch.ops.warp import warp_per_frame, warp_rgb, warp_shared
    rng = np.random.default_rng(5)

    def on_card(*shape, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(last_card)

    feat, grid = on_card(1, 32, 32, 32), on_card(4, 32, 32, 2, scale=0.5)
    wk = on_card(3, 32)
    map5 = on_card(1, 16, 128, 128).to(torch.bfloat16)
    grid5 = on_card(1, 128, 128, 2, scale=0.5)
    with torch.cuda.device(0):
        before = dict(LAUNCHES)
        warp_shared(feat, grid)
        warp_rgb(feat, grid, wk)
        warp_per_frame(feat.expand(4, -1, -1, -1).contiguous(), grid)
        warp_bilinear_windowed(map5, grid5)
        make(torch.float32, torch.float32)(on_card(1, 8, 128, 128))
        torch.cuda.synchronize(last_card)
        assert torch.cuda.current_device() == 0
        assert torch.empty(1, device="cuda").device == torch.device("cuda", 0)
    for name in ("warp_shared", "warp_rgb", "warp_per_frame", "warp_window",
                 "fma_dtype"):
        assert LAUNCHES[name] == before.get(name, 0) + 1
