"""The port's per-frame warp (K3's function) and warp + ToRGB (K2's) against
float_tpu's TPU kernels run in Pallas TPU interpret mode and against
torch's own F.grid_sample; K4's function (the round-1 lane-packed shared
warp) against the port's shared warp.

On CPU tensors the dispatchers take the plain versions and launch no
kernel; the kernels themselves are compared with the plain versions on a
CUDA card by the tests marked ``cuda`` (skipped without a card) and by
chip_smoke.py."""
import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import float_tpu.ops.pallas.shift_warp_kernel as j_k3
from float_tpu.ops.nhwc import flow_needed_disp, warp_cl
from float_tpu.ops.pallas.shift_warp_packed import warp_shared_feat_packed
from float_tpu.ops.pallas.shift_warp_v2 import (pick_groups,
                                                warp_shared_feat_v2_packed_rgb)
from float_torch.kernels import LAUNCHES
from float_torch.kernels.warp_rgb import warp_rgb_cuda
from float_torch.kernels.warp_shared import warp_per_frame_cuda
from float_torch.ops.warp import (warp_per_frame, warp_per_frame_ref, warp_rgb,
                                  warp_rgb_ref, warp_shared_ref)
from test_torch_warp import CASES, make_grid
from torch_parity import max_err, randn

BF16_FLOOR = 6.3e-2      # tests/test_warp_v2_interpret.py's bf16 bound


def _bf16(x):
    """A jnp bf16 array and the same values as a torch bf16 tensor."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _unpack_rgb(rgb_p, b, h, groups):
    """shift_warp_v2's lane-packed RGB (B/g, H, W, 4g) -> (B, H, W, 3), as
    tests/test_warp_v2_interpret.py unpacks it."""
    rgb = rgb_p.reshape(b // groups, h, h, groups, 4)[..., :3]
    return jnp.transpose(rgb, (0, 3, 1, 2, 4)).reshape(b, h, h, 3)


# --- K3: per-frame maps ----------------------------------------------------

@pytest.mark.parametrize("c", [32, 128])
@pytest.mark.parametrize("amp", [1.5, 10.0])
def test_per_frame_ref_matches_tpu_kernel_interpret(monkeypatch, c, amp):
    """warp_cl's per-frame branch runs the real K3 body
    (shift_warp_kernel._kernel) and its beyond-D cond fixup, at 128²,
    2 frames, bf16."""
    calls = []
    real = j_k3._shift_warp_nhwc
    monkeypatch.setattr(j_k3, "_shift_warp_nhwc",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(c + int(amp))
    b, h = 2, 128
    feat_j, feat_t = _bf16(randn(rng, b, h, h, c))
    grid = make_grid(rng, b, h, h, amp)
    # one jitted program, waited for before any other JAX op: an
    # interpret-mode kernel's callbacks dispatch JAX work, and an eager op
    # issued while they run (here warp_cl's fixup) can deadlock with them
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(
            lambda f, g: warp_cl(f, g, use_kernel=True))(
                feat_j, jnp.asarray(grid)))
    assert calls, "warp_cl did not take the K3 branch"
    got = warp_per_frame_ref(feat_t, torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, h, c)
    assert max_err(got, want) < BF16_FLOOR


@pytest.mark.parametrize("h,w,c,b,amp,zoom", CASES)
def test_per_frame_ref_matches_torch_grid_sample(h, w, c, b, amp, zoom):
    rng = np.random.default_rng(h * c + b)
    feat = torch.from_numpy(randn(rng, b, h, w, c))
    grid = torch.from_numpy(make_grid(rng, b, h, w, amp, zoom))
    want = F.grid_sample(feat.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros",
                         align_corners=False).permute(0, 2, 3, 1)
    assert max_err(warp_per_frame_ref(feat, grid), want) <= 1e-5


def test_per_frame_of_one_repeated_map_is_the_shared_warp():
    rng = np.random.default_rng(4)
    feat = torch.from_numpy(randn(rng, 1, 16, 24, 8))
    grid = torch.from_numpy(make_grid(rng, 3, 16, 24, 5.0))
    assert torch.equal(warp_per_frame_ref(feat.expand(3, -1, -1, -1), grid),
                       warp_shared_ref(feat, grid))


# --- K2: shared warp + ToRGB -----------------------------------------------

def test_rgb_ref_matches_tpu_kernel_interpret():
    """The real K2 body (shift_warp_v2._kernel_rgb) at 128², 8 frames,
    C=32, flows within D=2."""
    rng = np.random.default_rng(17)
    b, h, c = 8, 128, 32
    feat_j, feat_t = _bf16(randn(rng, 1, h, h, c))
    grid = make_grid(rng, b, h, h, 0.9)
    wk = randn(rng, 3, c, scale=0.2)
    groups = pick_groups(c, b)
    with pltpu.force_tpu_interpret_mode():
        rgb_p, flags = jax.block_until_ready(jax.jit(
            lambda f, g, w: warp_shared_feat_v2_packed_rgb(
                f, g, w, max_disp=2)[:2])(
            feat_j, jnp.asarray(grid), jnp.asarray(wk)))
    assert int(flags[0]) == 0, "flow beyond D"
    want = _unpack_rgb(rgb_p, b, h, groups)
    got = warp_rgb_ref(feat_t, torch.from_numpy(grid), torch.from_numpy(wk))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, h, 3)
    assert max_err(got, want) < 2 * BF16_FLOOR


@pytest.mark.parametrize("h,w,c,b,amp,zoom", CASES)
def test_rgb_ref_matches_grid_sample_and_conv(h, w, c, b, amp, zoom):
    rng = np.random.default_rng(h + c * b)
    feat = torch.from_numpy(randn(rng, 1, h, w, c))
    grid = torch.from_numpy(make_grid(rng, b, h, w, amp, zoom))
    wk = torch.from_numpy(randn(rng, 3, c, scale=0.3))
    warped = F.grid_sample(feat.permute(0, 3, 1, 2).expand(b, -1, -1, -1),
                           grid, mode="bilinear", padding_mode="zeros",
                           align_corners=False)
    want = F.conv2d(warped, wk[:, :, None, None]).permute(0, 2, 3, 1)
    assert max_err(warp_rgb_ref(feat, grid, wk), want) <= 1e-5


# --- K4: the lane-packed shared warp ---------------------------------------

@pytest.mark.parametrize("amp", [2.0, 8.0])
def test_shared_ref_matches_packed_tpu_kernel_interpret(amp):
    """The real K4 body (shift_warp_packed._kernel) at 128², 8 frames,
    C=32, with flows within and beyond D=3 (its cond-gather fixup)."""
    rng = np.random.default_rng(int(amp) + 40)
    b, h, c = 8, 128, 32
    feat_j, feat_t = _bf16(randn(rng, 1, h, h, c))
    grid = make_grid(rng, b, h, h, amp)
    beyond = int(flow_needed_disp(jnp.asarray(grid), h, h)) > 3
    assert beyond == (amp > 3)
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(
            warp_shared_feat_packed, static_argnums=2)(
                feat_j, jnp.asarray(grid), 3))
    got = warp_shared_ref(feat_t, torch.from_numpy(grid))
    assert max_err(got, want) < BF16_FLOOR


# --- dispatch and wrappers -------------------------------------------------

def test_dispatchers_on_cpu_launch_no_kernel():
    rng = np.random.default_rng(5)
    feat = torch.from_numpy(randn(rng, 2, 16, 16, 8))
    grid = torch.from_numpy(make_grid(rng, 2, 16, 16, 2.0))
    wk = torch.from_numpy(randn(rng, 3, 8))
    before = dict(LAUNCHES)
    assert torch.equal(warp_per_frame(feat, grid),
                       warp_per_frame_ref(feat, grid))
    assert torch.equal(warp_rgb(feat[:1], grid, wk),
                       warp_rgb_ref(feat[:1], grid, wk))
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("call", [
    lambda: warp_per_frame_cuda(torch.zeros(2, 8, 8, 8),
                                torch.zeros(2, 8, 8, 2)),
    lambda: warp_rgb_cuda(torch.zeros(1, 8, 8, 8), torch.zeros(2, 8, 8, 2),
                          torch.zeros(3, 8))], ids=["per_frame", "rgb"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_plain_versions_refuse_mismatched_batches():
    with pytest.raises(ValueError):
        warp_per_frame_ref(torch.zeros(3, 8, 8, 4), torch.zeros(2, 8, 8, 2))
    with pytest.raises(ValueError):
        warp_rgb_ref(torch.zeros(1, 8, 8, 4), torch.zeros(2, 8, 8, 2),
                     torch.zeros(3, 5))


# --- the kernels on the card -----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _tol(feat, dtype):
    scale = feat.float().abs().max().item()
    return (2.0 ** -7 if dtype == torch.bfloat16 else 1e-6) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size,c,b", [(8, 512, 1), (128, 128, 4),
                                      (512, 32, 1)])
def test_per_frame_kernel_matches_plain_on_card(cuda_device, dtype, size, c,
                                                b):
    rng = np.random.default_rng(size)
    feat = torch.from_numpy(randn(rng, b, size, size, c)).to(cuda_device,
                                                              dtype)
    grid = torch.from_numpy(make_grid(rng, b, size, size, 12.0, 1.2)).to(
        cuda_device)
    before = LAUNCHES["warp_per_frame"]
    out = warp_per_frame(feat, grid)
    assert LAUNCHES["warp_per_frame"] == before + 1
    assert max_err(out, warp_per_frame_ref(feat, grid)) <= _tol(feat, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size,c,b", [(128, 128, 24), (512, 32, 4)])
def test_rgb_kernel_matches_plain_on_card(cuda_device, dtype, size, c, b):
    rng = np.random.default_rng(size + 1)
    feat = torch.from_numpy(randn(rng, 1, size, size, c)).to(cuda_device,
                                                              dtype)
    grid = torch.from_numpy(make_grid(rng, b, size, size, 5.0, 1.2)).to(
        cuda_device)
    wk = torch.from_numpy(randn(rng, 3, c, scale=0.2)).to(cuda_device)
    before = LAUNCHES["warp_rgb"]
    out = warp_rgb(feat, grid, wk)
    assert LAUNCHES["warp_rgb"] == before + 1
    # the contraction sums in another order than the plain matmul
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
        * feat.float().abs().max().item() * wk.abs().sum(1).max().item()
    assert max_err(out, warp_rgb_ref(feat, grid, wk)) <= tol
