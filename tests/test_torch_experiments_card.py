"""float_torch.experiments without JAX: the gates' arithmetic, the
wrappers' refusals, the two entry points on the CPU and without a card,
and, on a card, K5 and K6 against their plain versions, and the decode's
warps K1-K3 on grids with NaN and infinite entries.  Imports neither
JAX nor float_tpu, so the card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_torch_experiments_card.py``.
The CPU parity against the TPU experiments is
tests/test_torch_experiments.py."""
import pytest
import torch

import chip_smoke
from float_torch.experiments import fma_dtype_bench as fb
from float_torch.experiments import warp_selection_matmul as ws
from float_torch.kernels import LAUNCHES
from float_torch.kernels.fma_dtype import fma_chain_cuda
from float_torch.kernels.warp_window import warp_window_cuda

VARIANTS = {"f32_f32": (torch.float32, torch.float32),
            "bf16_f32": (torch.bfloat16, torch.float32),
            "bf16_bf16": (torch.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_ulps():
    tiny = 2.0 ** -133                  # the least positive bf16
    a = torch.tensor([1.0, -1.0, 0.0, -0.0, 1.0, 3.0, tiny],
                     dtype=torch.bfloat16)
    b = torch.tensor([1.0078125, -1.0, -0.0, 0.0, 1.015625, -3.0, -tiny],
                     dtype=torch.bfloat16)
    assert ws.bf16_ulps(a, b).tolist() == [1, 0, 0, 0, 2, 2 * 0x4040, 2]


def test_windowed_refuses_what_supports_refuses():
    feat = torch.zeros(1, 16, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="warp_bilinear_windowed"):
        ws.warp_bilinear_windowed(feat, torch.zeros(1, 64, 128, 2))


def test_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        warp_window_cuda(torch.zeros(1, 128, 128, 16, dtype=torch.bfloat16),
                         torch.zeros(1, 128, 128, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fma_chain_cuda(torch.zeros(16), torch.float32, torch.zeros(4))


@pytest.mark.parametrize("shape,fdt,gdt,err", [
    ((1, 128, 128, 16), torch.float32, torch.float32, TypeError),
    ((1, 128, 128, 16), torch.bfloat16, torch.bfloat16, TypeError),
    ((1, 132, 128, 16), torch.bfloat16, torch.float32, ValueError),
    ((1, 128, 192, 16), torch.bfloat16, torch.float32, ValueError),
])
def test_k5_wrapper_refuses_what_the_kernel_does_not_take(shape, fdt, gdt,
                                                          err):
    """K5's own rules, checked before the device: a bf16 map, an f32 grid,
    H % 8 == 0 and W % 128 == 0."""
    feat = torch.zeros(shape, dtype=fdt)
    grid = torch.zeros((*shape[:3], 2), dtype=gdt)
    with pytest.raises(err, match="warp_window|H % 8"):
        warp_window_cuda(feat, grid)


def test_mains_on_cpu(capsys):
    rows = ws.main(["--device", "cpu"])
    assert [(r["size"], r["c"], r["b"]) for r in rows] == [(128, 16, 1)]
    assert rows[0]["overflow_px"] == 0 and "k5_ms" not in rows[0]
    out = capsys.readouterr().out
    assert "CPU host clock" in out and "overflow px 0" in out
    times = fb.main(["--device", "cpu"])
    assert sorted(times) == [fb.N_OPS, fb.LONG_OPS]
    out = capsys.readouterr().out
    assert "plain" in out and out.count("speedup") == 2


def test_mains_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ws.main, fb.main):
        with pytest.raises(RuntimeError, match="none is available"):
            main([])


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def equal_nan_aware(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same elements, every other element equal."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got[~nan],
                                                         want[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 24, 3])
def test_k5_matches_plain_on_card(cuda_device, c):
    """C = 16 and 24 (16-byte vectors), 3 (one channel a thread); flows of
    12 px and a zoom: in-window and overflow pixels, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    feat = torch.randn((2, c, 256, 256), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    grid = ws.make_grid(2, 256, 12.0, gen, cuda_device) * 1.1
    before = LAUNCHES["warp_window"]
    got = ws.warp_bilinear_windowed(feat, grid)
    assert LAUNCHES["warp_window"] == before + 1
    want = ws.warp_bilinear_windowed_ref(feat, grid)
    ovf = ws.overflow_mask(256, 256, grid[..., 1], grid[..., 0], 8, 64)
    assert ovf.any() and not ovf.all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "far", "out", "mixed",
                                  "nonfinite"])
@pytest.mark.parametrize("size,c", [(128, 128), (512, 32)])
def test_k5_matches_plain_on_grid_kinds(cuda_device, kind, size, c):
    """K5 on every grid kind of chip_smoke.py (flows of 3 and 20 px, a
    zoom-out, far pixels in every cell, NaN and infinite entries) at two
    of the experiment's levels: equal to warp_bilinear_windowed_ref bit
    for bit, NaN positions included."""
    gen = torch.Generator(device=cuda_device).manual_seed(size + c)
    feat = torch.randn((2, size, size, c), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    grid = chip_smoke.make_grid(kind, 2, size, gen)
    got = warp_window_cuda(feat, grid)
    want = ws.warp_bilinear_windowed_ref(feat.permute(0, 3, 1, 2), grid) \
        .permute(0, 2, 3, 1)
    assert equal_nan_aware(got, want)
    assert got.isnan().any() == (kind == "nonfinite")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_warps_on_nonfinite_grid(cuda_device, dtype):
    """K1 and K3 equal their plain versions on a grid with NaN and
    infinite entries, NaN positions included; K2 NaN at the same
    positions and within its tolerance elsewhere."""
    from float_torch.ops.warp import (warp_per_frame, warp_per_frame_ref,
                                      warp_rgb, warp_rgb_ref, warp_shared,
                                      warp_shared_ref)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    feat = torch.randn((4, 128, 128, 128), generator=gen,
                       device=cuda_device).to(dtype)
    grid = chip_smoke.make_grid("nonfinite", 4, 128, gen)
    wk = torch.randn((3, 128), generator=gen, device=cuda_device) / 11.3
    one = feat[:1].contiguous()
    assert equal_nan_aware(warp_shared(one, grid), warp_shared_ref(one, grid))
    assert equal_nan_aware(warp_per_frame(feat, grid),
                           warp_per_frame_ref(feat, grid))
    got, want = warp_rgb(one, grid, wk), warp_rgb_ref(one, grid, wk)
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
        * one.float().abs().max() * wk.abs().sum(1).max()
    assert (got[~nan].float() - want[~nan].float()).abs().max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k6_matches_plain_on_card(cuda_device, variant):
    dtype, acc = VARIANTS[variant]
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((4, *fb.TILE), generator=gen, device=cuda_device) \
        .to(dtype)
    before = LAUNCHES["fma_dtype"]
    got = fb.make(dtype, acc)(x)
    assert LAUNCHES["fma_dtype"] == before + 1
    want = fb.fma_chain_ref(x, acc)
    if acc == torch.float32:
        assert torch.equal(got, want)
    else:
        assert ws.bf16_ulps(got, want).max().item() <= 1
