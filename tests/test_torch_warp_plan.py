"""Launch plans of the staged shared-map warps (K1, K2) and the grids that
stress their staged windows.

The planner (``float_torch.kernels.warp_plan``) mirrors the launchers'
block decomposition, so its coverage and shared memory are checked here
without a card, at every config-1 level, frame batch and dtype.  The
plain warps the kernels are held to on the card are held here against
float_tpu's K1 and K2 bodies in Pallas TPU interpret mode on the "mixed"
grid: smooth flows with one pixel of every 8 x 8 cell sent far outside
any window (chip_smoke.py's grid kind of the same name)."""
import math

import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu.ops.pallas.shift_warp_kernel import _overflow_mask
from float_tpu.ops.pallas.shift_warp_v2 import (warp_shared_feat_v2,
                                                warp_shared_feat_v2_packed_rgb)
from float_torch.kernels import LAUNCHES
from float_torch.kernels.warp_plan import (DIRECT, DIRECT_BELOW, SMEM_LIMIT,
                                           Plan, blocks, check, grid_dims,
                                           plan_rgb, plan_shared, smem_bytes,
                                           window_cap)
from float_torch.ops.warp import (warp_rgb, warp_rgb_ref, warp_shared,
                                  warp_shared_ref)
from test_torch_warp import make_grid
from torch_parity import max_err, randn

BF16_FLOOR = 6.3e-2      # tests/test_warp_v2_interpret.py's bf16 bound
# The seven synthesis levels of a 512² decode (size, channels), the frame
# batches the decode paths give a shared warp, and the element sizes.
LEVELS = ((8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64),
          (512, 32))
BATCHES = (24, 12, 8, 4, 1)
ESIZES = {"bf16": 2, "f32": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's thread pool only oversubscribes the CPU under
    the suite's parallel workers (as in test_torch_warp_variants)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_grid(rng, b, h, w, amp_px):
    """make_grid's smooth flow of ``amp_px`` px, with one pixel of every
    8 x 8 cell (at a random place) sent anywhere in [-1.5, 1.5]^2."""
    grid = make_grid(rng, b, h, w, amp_px)
    for y0 in range(0, h, 8):
        for x0 in range(0, w, 8):
            ys = y0 + rng.integers(0, min(8, h - y0), b)
            xs = x0 + rng.integers(0, min(8, w - x0), b)
            grid[np.arange(b), ys, xs] = rng.uniform(-1.5, 1.5, (b, 2))
    return grid


def assert_exact_cover(plan: Plan, b, h, w, c):
    """The plan's blocks are distinct (frames, rows, columns, channels)
    boxes, each axis' spans partition it, and every combination of spans
    is one block: every output element is covered exactly once."""
    boxes = [tuple((r.start, r.stop) for r in blk)
             for blk in blocks(plan, b, h, w, c)]
    assert len(set(boxes)) == len(boxes)
    n_combos = 1
    for axis, size in enumerate((b, h, w, c)):
        spans = sorted({box[axis] for box in boxes})
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(lo < hi for lo, hi in spans)
        assert all(a[1] == nxt[0] for a, nxt in zip(spans, spans[1:]))
        n_combos *= len(spans)
    assert len(boxes) == n_combos == math.prod(grid_dims(plan, b, h, w, c))


@pytest.mark.parametrize("dtype", sorted(ESIZES))
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("size,c", LEVELS)
def test_shared_plan_covers_each_output_once_and_fits(size, c, b, dtype):
    esize = ESIZES[dtype]
    plan = plan_shared(b, size, size, c, esize)
    assert_exact_cover(plan, b, size, size, c)
    assert smem_bytes(plan, size, size, c, esize) <= SMEM_LIMIT
    if plan == DIRECT:   # a call too small to hide the staging behind
        assert b * size * size * c * esize < DIRECT_BELOW
        return
    assert plan.cslice * esize <= 128
    cap_h, cap_w = window_cap(plan, size, size)
    assert cap_h >= min(size, plan.tile_h + 1)
    assert cap_w >= min(size, plan.tile_w + 1)


@pytest.mark.parametrize("dtype", sorted(ESIZES))
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("size,c", LEVELS)
def test_rgb_plan_covers_each_output_once_and_fits(size, c, b, dtype):
    esize = ESIZES[dtype]
    plan = plan_rgb(b, size, size, c, esize)
    assert plan.cslice == c
    assert_exact_cover(plan, b, size, size, c)
    assert smem_bytes(plan, size, size, c, esize, rgb=True) <= SMEM_LIMIT
    assert plan.vpt == 1 and plan.halo >= 1


@pytest.mark.parametrize("b,h,w,c,plan", [
    (5, 20, 12, 24, Plan(8, 5, 8, 2, 1, 1)),
    (3, 7, 9, 16, Plan(4, 4, 16, 3, 0, 4)),
    (1, 33, 17, 8, Plan(16, 16, 8, 1, 4, 2))])
def test_plan_cover_counted_element_by_element(b, h, w, c, plan):
    """Ragged tiles and frame groups: count every element's blocks."""
    count = np.zeros((b, h, w, c), np.int32)
    for fr, rows, cols, chans in blocks(plan, b, h, w, c):
        count[fr.start:fr.stop, rows.start:rows.stop, cols.start:cols.stop,
              chans.start:chans.stop] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("args,rgb", [
    ((Plan(16, 16, 12, 1, 4, 1), 4, 64, 64, 32, 2), False),   # slice not vectors
    ((Plan(16, 16, 64, 1, 4, 1), 4, 64, 64, 96, 2), False),   # slice not dividing
    ((Plan(64, 64, 64, 1, 8, 1), 4, 256, 256, 64, 2), False),  # window > 227 KB
    ((Plan(0, 16, 32, 1, 4, 1), 4, 64, 64, 32, 2), False),
    ((Plan(8, 32, 16, 1, 4, 1), 4, 64, 64, 32, 2), True),     # K2 takes all C
    ((Plan(8, 32, 32, 1, 4, 2), 4, 64, 64, 32, 2), True),     # K2: vpt 1
    ((Plan(16, 16, 32, 1, 4, 3), 4, 64, 64, 32, 2), False),   # no such vpt
    ((Plan(16, 16, 16, 1, 4, 4), 4, 64, 64, 32, 2), False),   # 2 vectors < 4
])
def test_check_refuses_plans_the_launchers_do_not_take(args, rgb):
    with pytest.raises(ValueError):
        check(*args, rgb=rgb)


def test_planners_refuse_partial_vectors():
    with pytest.raises(ValueError):
        plan_shared(4, 64, 64, 12, 2)
    with pytest.raises(ValueError):
        plan_rgb(4, 64, 64, 6, 4)


def test_plain_warps_give_nan_for_nan_coordinates():
    """The plain warps follow float_tpu on NaN and infinite grid entries
    (tests/test_torch_nonfinite_grid.py holds them to float_tpu itself;
    the kernels follow them on the card, held by chip_smoke.py): a NaN
    coordinate becomes tap 0 with a NaN weight, so its pixel is NaN in
    every channel; an infinite one has no tap in the image, so a pixel
    with infinite entries only is 0."""
    rng = np.random.default_rng(11)
    feat = torch.from_numpy(randn(rng, 1, 16, 16, 8))
    grid = make_grid(rng, 3, 16, 16, 2.0)
    bad = rng.random(grid.shape[:3]) < 0.1
    grid[bad, rng.integers(0, 2)] = np.array([np.nan, np.inf, -np.inf])[
        rng.integers(0, 3, int(bad.sum()))]
    grid_t = torch.from_numpy(grid)
    wk = torch.from_numpy(randn(rng, 3, 8))
    nan_px = torch.from_numpy(np.isnan(grid).any(-1))
    inf_px = torch.from_numpy(bad) & ~nan_px
    assert nan_px.any() and inf_px.any()
    for out in (warp_shared_ref(feat, grid_t), warp_rgb_ref(feat, grid_t, wk)):
        assert out.isnan().all(-1)[nan_px].all()
        assert torch.isfinite(out[~nan_px]).all()
        assert (out[inf_px] == 0).all()


def nan_aware_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| off the NaN elements, which must be the same in
    both (inf where they are not)."""
    if not torch.equal(got.isnan(), want.isnan()):
        return math.inf
    ok = ~want.isnan()
    return max_err(got[ok], want[ok]) if ok.any() else 0.0


# --- the plain warps against the TPU kernels on the mixed grid --------------

def _bf16(x):
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


B, H, W, C, D = 8, 16, 128, 32, 3     # the smallest map the TPU kernels take


def test_shared_ref_matches_tpu_kernel_interpret_on_mixed_grid():
    """The real K1 body (shift_warp_v2._kernel) with its beyond-D fixup:
    exact for the far pixels too."""
    rng = np.random.default_rng(21)
    feat_j, feat_t = _bf16(randn(rng, 1, H, W, C))
    grid = mixed_grid(rng, B, H, W, 2.0)
    # one jitted program, waited for before any other JAX op: the
    # interpret-mode kernel's callbacks dispatch JAX work, and an eager op
    # issued while they run can deadlock with them
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jax.jit(
            lambda f, g: warp_shared_feat_v2(f, g, max_disp=D,
                                             apply_fixup=True))(
                feat_j, jnp.asarray(grid)))
    got = warp_shared_ref(feat_t, torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, C)
    assert max_err(got, want) < BF16_FLOOR


def test_rgb_ref_matches_tpu_kernel_interpret_on_mixed_grid():
    """The real K2 body (shift_warp_v2._kernel_rgb) where its flags say it
    is exact, and the reference's re-decode (K1 with its fixup, then the
    1x1 ToRGB) at the pixels beyond D it flags."""
    rng = np.random.default_rng(22)
    feat_j, feat_t = _bf16(randn(rng, 1, H, W, C))
    grid = mixed_grid(rng, B, H, W, 1.5)
    wk = randn(rng, 3, C, scale=0.2)
    grid_j = jnp.asarray(grid)
    with pltpu.force_tpu_interpret_mode():
        rgb_p, flags, groups = jax.block_until_ready(jax.jit(
            lambda f, g, w: warp_shared_feat_v2_packed_rgb(
                f, g, w, max_disp=D), static_argnums=())(
            feat_j, grid_j, jnp.asarray(wk)))
        fixed = jax.block_until_ready(jax.jit(
            lambda f, g: warp_shared_feat_v2(f, g, max_disp=D,
                                             apply_fixup=True))(
                feat_j, grid_j))
    assert int(flags[0]) > 0, "the mixed grid must reach the fixup"
    beyond = np.asarray(jax.jit(_overflow_mask, static_argnums=(0, 1, 4))(
        H, W, grid_j[..., 1], grid_j[..., 0], D))
    groups = int(groups)
    rgb = np.asarray(rgb_p, np.float32).reshape(B // groups, H, W, groups, 4)
    rgb = rgb[..., :3].transpose(0, 3, 1, 2, 4).reshape(B, H, W, 3)
    redecoded = np.asarray(fixed, np.float32) @ wk.T
    want = np.where(beyond[..., None], redecoded, rgb)
    got = warp_rgb_ref(feat_t, torch.from_numpy(grid), torch.from_numpy(wk))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, 3)
    assert max_err(got, want) < 2 * BF16_FLOOR


# --- the kernels on the card -------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["mixed", "nonfinite"])
@pytest.mark.parametrize("size,c,b", [(32, 512, 4), (128, 128, 12),
                                      (512, 32, 24)])
def test_staged_kernels_match_plain_on_card(cuda_device, dtype, kind, size,
                                            c, b):
    rng = np.random.default_rng(size + b)
    grid = mixed_grid(rng, b, size, size, 3.0)
    if kind == "nonfinite":
        grid = make_grid(rng, b, size, size, 3.0)
        bad = rng.random(grid.shape) < 0.03
        grid[bad] = np.array([np.nan, np.inf, -np.inf])[
            rng.integers(0, 3, int(bad.sum()))]
    feat = torch.from_numpy(randn(rng, 1, size, size, c)).to(cuda_device,
                                                              dtype)
    grid = torch.from_numpy(grid).to(cuda_device)
    wk = torch.from_numpy(randn(rng, 3, c, scale=0.2)).to(cuda_device)
    before = dict(LAUNCHES)
    out, rgb = warp_shared(feat, grid), warp_rgb(feat, grid, wk)
    assert LAUNCHES["warp_shared"] == before.get("warp_shared", 0) + 1
    assert LAUNCHES["warp_rgb"] == before.get("warp_rgb", 0) + 1
    # K1 rounds in the plain version's order: bit for bit, NaN positions
    # (a NaN grid coordinate) equal
    assert nan_aware_err(out, warp_shared_ref(feat, grid)) == 0.0
    # K2 contracts with FMAs in another order than the plain matmul
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) \
        * feat.float().abs().max().item() * wk.abs().sum(1).max().item()
    assert nan_aware_err(rgb, warp_rgb_ref(feat, grid, wk)) <= tol
    assert out.isnan().any() == (kind == "nonfinite")
