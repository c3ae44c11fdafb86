"""float_torch.experiments without JAX: the gates' arithmetic, the
wrappers' refusals, the two entry points on the CPU and without a card,
and, on a card, K5 and K6 against their plain versions.  Imports neither
JAX nor float_tpu, so the card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_torch_experiments_card.py``.
The CPU parity against the TPU experiments is
tests/test_torch_experiments.py."""
import pytest
import torch

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


def test_mains_on_cpu(capsys):
    rows = ws.main(["--device", "cpu"])
    assert [(r["size"], r["c"], r["b"]) for r in rows] == [(128, 16, 1)]
    assert rows[0]["mma_flops_dense"] == ws.dense_mma_flops(1, 128, 128, 16)
    assert "not measured (CPU)" in capsys.readouterr().out
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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 24, 3])
def test_k5_matches_plain_on_card(cuda_device, c):
    """C = 16 (two 8-channel blocks a launch), 24 (one), 3 (padded to 8);
    flows of 12 px and a zoom: in-window and overflow pixels."""
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    feat = torch.randn((2, c, 256, 256), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    grid = ws.make_grid(2, 256, 12.0, gen, cuda_device) * 1.1
    before = LAUNCHES["warp_window"]
    got = ws.warp_bilinear_windowed(feat, grid)
    assert LAUNCHES["warp_window"] == before + 1
    want = ws.warp_bilinear_windowed_ref(feat, grid)
    ovf = ws.overflow_mask(256, 256, grid[..., 1], grid[..., 0], 8, 64)
    ovf = ovf[:, None].expand_as(got)
    assert ovf.any() and not ovf.all()
    assert torch.equal(got[ovf], want[ovf])
    assert ws.bf16_ulps(got, want).max().item() <= 1


@pytest.mark.cuda
def test_k5_counts_the_mmas_it_issues(cuda_device):
    """A smooth flow's taps fill few (row, k-block) products: K5 issues
    some, far fewer than the dense count, and the same count again."""
    from float_torch.kernels.warp_window import MMA_FLOPS
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    feat = torch.randn((2, 128, 128, 32), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    grid = ws.make_grid(2, 128, 5.0, gen, cuda_device)
    count = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    warp_window_cuda(feat, grid, mma_count=count)
    issued = count.item() * MMA_FLOPS
    assert 0 < issued < ws.dense_mma_flops(2, 128, 128, 32) / 16
    warp_window_cuda(feat, grid, mma_count=count)
    assert count.item() * MMA_FLOPS == 2 * issued


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
