"""The port's shared-feature warp (float_torch.ops.warp) against three
oracles: float_tpu's exact NHWC patch gather, torch's own F.grid_sample,
and the real TPU kernel body (shift_warp_v2) run in Pallas TPU interpret
mode — with flows inside and beyond +-7 px and taps outside the image.

On CPU tensors the dispatcher takes the plain version and launches no
kernel; the kernel itself is compared with the plain version on a CUDA
card by the test marked ``cuda`` (skipped without a card) and by
chip_smoke.py."""
import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from float_tpu.ops.nhwc import grid_sample_bilinear_nhwc
from float_tpu.ops.pallas.shift_warp_v2 import warp_shared_feat_v2
from float_torch.kernels import LAUNCHES
from float_torch.kernels.warp_shared import warp_shared_cuda
from float_torch.ops.warp import warp_shared, warp_shared_ref
from torch_parity import max_err, randn

BF16_FLOOR = 6.3e-2      # tests/test_warp_v2_interpret.py's bf16 bound


def make_grid(rng, b, h, w, amp_px, zoom=1.0):
    """(B, H, W, 2) xy grid: pixel-centre identity (scaled by ``zoom``;
    > 1 sends taps outside the image) plus a smooth random flow of at most
    ``amp_px`` pixels."""
    ys = np.linspace(-1 + 1 / h, 1 - 1 / h, h, dtype=np.float32)
    xs = np.linspace(-1 + 1 / w, 1 - 1 / w, w, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    ident = np.stack([gx, gy], -1)[None] * zoom
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    flow = np.zeros((b, h, w, 2), np.float32)
    for k in range(3):
        a = rng.uniform(-1, 1, (b, 1, 1, 2))
        fy, fx, ph = rng.uniform(0.5, 2.0, 3)
        flow += a * np.sin(2 * np.pi * (fy * yy + fx * xx + ph))[None, ..., None]
    flow *= amp_px / max(np.abs(flow).max(), 1e-6)
    return (ident + flow * np.asarray([2.0 / w, 2.0 / h])).astype(np.float32)


CASES = [  # (h, w, c, b, flow amplitude px, zoom)
    (16, 16, 8, 3, 0.7, 1.0), (16, 24, 16, 2, 3.0, 1.0),
    (32, 32, 8, 2, 12.0, 1.0), (24, 16, 4, 3, 20.0, 1.0),
    (16, 16, 8, 2, 2.0, 1.4), (8, 8, 32, 1, 40.0, 1.0)]


@pytest.mark.parametrize("h,w,c,b,amp,zoom", CASES)
def test_ref_matches_xla_gather(h, w, c, b, amp, zoom):
    rng = np.random.default_rng(h * w + b)
    feat = randn(rng, 1, h, w, c)
    grid = make_grid(rng, b, h, w, amp, zoom)
    want = grid_sample_bilinear_nhwc(
        jnp.broadcast_to(jnp.asarray(feat), (b, h, w, c)), jnp.asarray(grid))
    got = warp_shared_ref(torch.from_numpy(feat), torch.from_numpy(grid))
    assert got.shape == (b, h, w, c)
    assert max_err(got, want) <= 1e-6


@pytest.mark.parametrize("h,w,c,b,amp,zoom", CASES)
def test_ref_matches_torch_grid_sample(h, w, c, b, amp, zoom):
    rng = np.random.default_rng(h + w + c)
    feat = torch.from_numpy(randn(rng, 1, h, w, c))
    grid = torch.from_numpy(make_grid(rng, b, h, w, amp, zoom))
    want = F.grid_sample(feat.permute(0, 3, 1, 2).expand(b, -1, -1, -1),
                         grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False).permute(0, 2, 3, 1)
    assert max_err(warp_shared_ref(feat, grid), want) <= 1e-5


@pytest.mark.parametrize("amp,zoom", [(1.5, 1.0), (10.0, 1.2)])
def test_ref_matches_tpu_kernel_interpret(amp, zoom):
    """The real K1 body (shift_warp_v2._kernel), exact for any flow through
    its beyond-D fixup, at 128², 8 frames, C=32, bf16."""
    rng = np.random.default_rng(int(amp))
    b, h, c = 8, 128, 32
    feat = jax.random.normal(jax.random.key(0), (1, h, h, c), jnp.bfloat16)
    grid = make_grid(rng, b, h, h, amp, zoom)
    # one jitted program, waited for before any other JAX op: the
    # interpret-mode kernel's callbacks dispatch JAX work, and the eager
    # fixup cond issued while they run can deadlock with them
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(
            lambda f, g: warp_shared_feat_v2(f, g, apply_fixup=True))(
                feat, jnp.asarray(grid)))
    feat_t = torch.from_numpy(np.array(feat, np.float32)).to(torch.bfloat16)
    got = warp_shared_ref(feat_t, torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, h, c)
    assert max_err(got, want) < BF16_FLOOR


def test_dispatcher_on_cpu_launches_no_kernel():
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(randn(rng, 1, 16, 16, 8))
    grid = torch.from_numpy(make_grid(rng, 2, 16, 16, 2.0))
    before = LAUNCHES["warp_shared"]
    out = warp_shared(feat, grid)
    assert LAUNCHES["warp_shared"] == before
    assert torch.equal(out, warp_shared_ref(feat, grid))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        warp_shared_cuda(torch.zeros(1, 8, 8, 8), torch.zeros(2, 8, 8, 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("amp,zoom", [(3.0, 1.0), (20.0, 1.0), (5.0, 1.3)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, amp, zoom):
    rng = np.random.default_rng(0)
    h, c, b = 128, 128, 12
    feat = torch.from_numpy(randn(rng, 1, h, h, c)).to(cuda_device, dtype)
    grid = torch.from_numpy(make_grid(rng, b, h, h, amp, zoom)).to(cuda_device)
    before = LAUNCHES["warp_shared"]
    out = warp_shared(feat, grid)
    assert LAUNCHES["warp_shared"] == before + 1
    ref = warp_shared_ref(feat, grid)
    scale = feat.float().abs().max().item()
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-6) * scale
    assert max_err(out, ref) <= tol
