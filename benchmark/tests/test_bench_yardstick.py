"""The frozen arithmetic equals the program's at config 1: FLOPs of
``float_torch.utils.flops``, the warp bound of ``chip_smoke.py``."""
import dataclasses

import pytest
import torch

import tiny
from harness import yardstick


@pytest.fixture(scope="module")
def cfg():
    from float_torch.config import FloatConfig
    return FloatConfig(compute_dtype="bfloat16", decode_batch=24)


def test_clip_flops(cfg):
    from float_torch.utils import flops
    f = dataclasses.asdict(cfg)
    assert yardstick.decode_matmul_flops_per_frame(512) == \
        flops.synthesis_flops_per_frame(512)["matmul_flops"]
    assert yardstick.fmt_flops_per_forward(f) == \
        flops.fmt_flops_per_forward(cfg)
    assert yardstick.sampler_flops(250, f) == \
        flops.sampling_flops_per_clip(250, cfg)
    # 20.26 TFLOP a 10 s clip
    assert abs(yardstick.clip_matmul_flops(250, f) / 1e12 - 20.265) < 1e-3
    assert yardstick.BF16_PEAK_FLOPS == flops.H100_BF16_PEAK_FLOPS
    assert yardstick.HBM_BPS == flops.H100_HBM_BPS


def test_config_file_is_config_1(cfg):
    from harness.spec import Cell
    cell = Cell(tiny.REPO, "ser-clip10s")
    assert cell.model["float"] == dataclasses.asdict(cfg)


@pytest.mark.parametrize("b,h,c", [(24, 512, 32), (24, 64, 256), (12, 8, 512),
                                   (4, 256, 64)])
def test_warp_bound(b, h, c):
    import sys
    sys.path.insert(0, str(tiny.REPO))
    import chip_smoke
    feat = torch.empty((1, h, h, c), dtype=torch.bfloat16)
    grid = torch.empty((b, h, h, 2))
    ms, _by = chip_smoke.warp_bound(feat, grid, c, 8 * c)
    assert yardstick.warp_shared_bound_s(b, h, h, c, 2) == pytest.approx(
        ms / 1e3, rel=1e-12)
