"""The port's plain warps against float_tpu on sampling grids that hold
NaN, +inf and -inf entries.

float_tpu converts each floored source coordinate to an integer tap with
``astype(int32)``, which on XLA turns NaN into 0 and saturates +-inf, and
weighs the taps from the fraction: a pixel with a NaN coordinate has
in-image taps with NaN weights and comes out NaN in every channel (even
where its other coordinate lies far outside the image), while a pixel
with only infinite coordinates has no tap in the image and comes out 0.
The port's plain versions must give the same: NaN at the same positions,
every other element within the tolerance of each function's existing
parity test.  The kernels are held to these plain versions on the card
(tests/test_torch_warp_plan.py, tests/test_torch_experiments_card.py and
chip_smoke.py's ``nonfinite`` grids).

Grids are made with numpy from a seed: a smooth flow, then a share of
pixels with NaN, +inf or -inf in x alone, in y alone or in both, a third
of the single ones with the other coordinate far outside the image."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu.ops.nhwc import grid_sample_bilinear_nhwc
from float_tpu.ops.warp import grid_sample_bilinear, grid_sample_bilinear_xla
from float_torch.experiments import warp_selection_matmul as ws
from float_torch.ops import warp as warp_mod
from float_torch.ops.warp import (grid_sample_bilinear_ref, warp_per_frame_ref,
                                  warp_rgb_ref, warp_shared_ref)
from test_torch_experiments import _interpret, _load, REPO
from test_torch_warp import BF16_FLOOR, make_grid
from torch_parity import np32, randn

F32_TOL = 1e-6           # test_torch_warp's exact-warp bound against XLA
RGB_TOL = 1e-5           # the 1x1 contraction after it, summed in f32
BAD = np.array([np.nan, np.inf, -np.inf], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nonfinite_grid(rng, b, h, w, share=0.08, amp_px=3.0, zoom=1.0):
    """make_grid's flow of ``amp_px`` px (identity scaled by ``zoom``) with
    ``share`` of the pixels given NaN,
    +inf or -inf in x alone, in y alone or in both (each kind a third),
    and a third of the single ones their other coordinate far outside
    the image (|g| in [1.5, 50] or 1e6)."""
    grid = make_grid(rng, b, h, w, amp_px, zoom)
    picked = rng.random((b, h, w)) < share
    n = int(picked.sum())
    mode = rng.integers(0, 3, n)            # 0: x, 1: y, 2: both
    vals = BAD[rng.integers(0, 3, (n, 2))]
    px = grid[picked]
    far = np.where(rng.random(n) < 0.5, rng.uniform(1.5, 50.0, n), 1e6) \
        * rng.choice([-1.0, 1.0], n)
    far_sel = (mode < 2) & (rng.random(n) < 1 / 3)
    for axis in (0, 1):
        set_bad = (mode == axis) | (mode == 2)
        px[set_bad, axis] = vals[set_bad, axis]
        other = far_sel & (mode == 1 - axis)
        px[other, axis] = far[other]
    grid[picked] = px
    return grid.astype(np.float32)


def nan_px(grid: np.ndarray) -> np.ndarray:
    return np.isnan(grid).any(-1)


def check_kinds(grid: np.ndarray) -> None:
    """The grid holds every kind of entry the tests are about."""
    g = grid.reshape(-1, 2)
    for v in BAD:
        hit = np.isnan(g) if np.isnan(v) else g == v
        assert (hit[:, 0] & np.isfinite(g[:, 1])).any()
        assert (hit[:, 1] & np.isfinite(g[:, 0])).any()
        assert (hit[:, 0] & ~np.isfinite(g[:, 1])).any()
    assert (np.isnan(g[:, 0]) & (np.abs(g[:, 1]) > 1.5)
            & np.isfinite(g[:, 1])).any()


def assert_nan_aware(got, want, tol: float, px_nan=None) -> None:
    """NaN at the same elements; every other element within ``tol``; and,
    where ``px_nan`` (B, H, W) is given, NaN exactly there in every
    channel (the last axis)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.isfinite(got[ok]).all()
    assert np.abs(got[ok] - want[ok]).max() <= tol
    if px_nan is not None:
        assert np.isnan(got).all(-1)[px_nan].all()
        assert not np.isnan(got).any(-1)[~px_nan].any()


# --- the exact warps ---------------------------------------------------------
# float_tpu's warps run eagerly, as test_torch_warp runs them: jitted,
# XLA:CPU contracts their multiply-adds, a few f32 ulp off either order.

B, H, W, C = 3, 16, 24, 8


@pytest.fixture(scope="module")
def exact_case():
    rng = np.random.default_rng(31)
    grid = nonfinite_grid(rng, B, H, W)
    check_kinds(grid)
    return dict(grid=grid, feat=randn(rng, B, H, W, C),
                wk=randn(rng, 3, C, scale=0.2))


@pytest.mark.parametrize("tpu_fn", [grid_sample_bilinear_xla,
                                    grid_sample_bilinear])
def test_grid_sample_ref_matches_float_tpu(exact_case, tpu_fn):
    feat = exact_case["feat"].transpose(0, 3, 1, 2)
    grid = exact_case["grid"]
    want = tpu_fn(jnp.asarray(feat), jnp.asarray(grid))
    got = grid_sample_bilinear_ref(torch.from_numpy(feat),
                                   torch.from_numpy(grid))
    assert_nan_aware(got.permute(0, 2, 3, 1), np.asarray(want).transpose(
        0, 2, 3, 1), F32_TOL, nan_px(grid))


def test_per_frame_ref_matches_float_tpu(exact_case):
    """warp_per_frame_ref against float_tpu's NHWC patch gather (the
    decode's exact warp)."""
    feat, grid = exact_case["feat"], exact_case["grid"]
    want = grid_sample_bilinear_nhwc(jnp.asarray(feat), jnp.asarray(grid))
    got = warp_per_frame_ref(torch.from_numpy(feat), torch.from_numpy(grid))
    assert_nan_aware(got, want, F32_TOL, nan_px(grid))


def test_shared_ref_matches_float_tpu(exact_case):
    feat, grid = exact_case["feat"][:1], exact_case["grid"]
    want = grid_sample_bilinear_nhwc(
        jnp.broadcast_to(jnp.asarray(feat), (B, H, W, C)), jnp.asarray(grid))
    got = warp_shared_ref(torch.from_numpy(feat), torch.from_numpy(grid))
    assert_nan_aware(got, want, F32_TOL, nan_px(grid))


def test_rgb_ref_matches_float_tpu(exact_case):
    """The NaN of a pixel passes through the 1x1 ToRGB into all three
    channels."""
    feat, grid, wk = (exact_case["feat"][:1], exact_case["grid"],
                      exact_case["wk"])
    warped = grid_sample_bilinear_nhwc(
        jnp.broadcast_to(jnp.asarray(feat), (B, H, W, C)), jnp.asarray(grid))
    want = np.asarray(warped, np.float32) @ wk.T
    got = warp_rgb_ref(torch.from_numpy(feat), torch.from_numpy(grid),
                       torch.from_numpy(wk))
    assert_nan_aware(got, want, RGB_TOL, nan_px(grid))


def test_infinite_only_pixels_are_zero(exact_case):
    """A pixel whose coordinates are infinite or far but not NaN has no
    tap in the image: 0 on both sides."""
    feat, grid = exact_case["feat"][:1], exact_case["grid"]
    inf_px = ~np.isfinite(grid).all(-1) & ~nan_px(grid)
    assert inf_px.any()
    got = warp_shared_ref(torch.from_numpy(feat), torch.from_numpy(grid))
    assert (got[torch.from_numpy(inf_px)] == 0).all()


def test_control_nan_as_no_tap_fails(exact_case, monkeypatch):
    """The port's former rule, a NaN coordinate with no tap in the image
    (a float test of each tap), gives 0 where float_tpu gives NaN: the
    NaN gate above fails it."""
    floor = warp_mod.tap_floor

    def nan_outside(f):
        i0, t = floor(f)
        return torch.where(torch.isnan(f), -2 ** 30, i0), t

    monkeypatch.setattr(warp_mod, "tap_floor", nan_outside)
    feat, grid = exact_case["feat"][:1], exact_case["grid"]
    want = grid_sample_bilinear_nhwc(
        jnp.broadcast_to(jnp.asarray(feat), (B, H, W, C)), jnp.asarray(grid))
    got = warp_shared_ref(torch.from_numpy(feat), torch.from_numpy(grid))
    assert not got.isnan().any()
    with pytest.raises(AssertionError):
        assert_nan_aware(got, want, F32_TOL)


# --- the windowed warp (K5's plain version) -----------------------------------

# W = 512: four tile columns, whose windows (256 columns) move with the
# tile, so a NaN x (tap column 0) lies in the window of the first and
# outside the others' (an overflow pixel there).  A power of two, as every
# width of the TPU experiment (128-512): the reference's (g + 1) * W is
# then exact.  At another width XLA:CPU, jitting the interpret-mode
# kernel, contracts (g + 1) * W - 1 into one rounding, which moves some
# coordinates by an f32 ulp and their bf16 weights by a step (at W = 384
# a few elements end several ulps off, with or without NaN in the grid).
WB, WH, WW, WC = 1, 128, 512, 8
MY, MX = 8, 64


@pytest.fixture(scope="module")
def tpu_warp():
    """experiments/pallas_warp_selection_matmul.py as
    test_torch_experiments loads it, its kernel in interpret mode."""
    import sys
    name = "float_tpu.ops.pallas.pallas_warp_selection_matmul"
    spec, mod = _load(name, REPO / "experiments" /
                      "pallas_warp_selection_matmul.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, name, mod)
        spec.loader.exec_module(mod)
        _interpret(mod)
        yield mod


@pytest.fixture(scope="module")
def window_case(tpu_warp):
    rng = np.random.default_rng(32)
    feat = torch.from_numpy(randn(rng, WB, WH, WW, WC)).to(torch.bfloat16)
    # flows of 12 px and a zoom: finite overflow pixels too
    grid = nonfinite_grid(rng, WB, WH, WW, share=0.03, amp_px=12.0, zoom=1.1)
    check_kinds(grid)
    jfeat = jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16)
    jgrid = jnp.asarray(grid)
    # one jitted program each: the interpret-mode kernel's callbacks
    # dispatch JAX work, and an eager op issued while they run can
    # deadlock with them
    body = jax.block_until_ready(jax.jit(
        lambda f, g: tpu_warp._warp_pallas_nhwc(f, g[..., 1], g[..., 0],
                                                MY, MX))(jfeat, jgrid))
    whole = jax.block_until_ready(jax.jit(
        lambda f, g: tpu_warp.warp_bilinear_pallas(
            jnp.transpose(f, (0, 3, 1, 2)), g, MY, MX))(jfeat, jgrid))
    mask = jax.jit(tpu_warp._overflow_mask, static_argnums=(0, 1, 4, 5))(
        WH, WW, jgrid[..., 1], jgrid[..., 0], MY, MX)
    return dict(feat=feat, grid=torch.from_numpy(grid), px_nan=nan_px(grid),
                body=torch.from_numpy(np.asarray(body, np.float32)),
                whole=torch.from_numpy(np.asarray(whole, np.float32)),
                mask=torch.from_numpy(np.array(mask)))


def test_overflow_mask_matches_tpu_on_nonfinite(window_case):
    grid = window_case["grid"]
    got = ws.overflow_mask(WH, WW, grid[..., 1], grid[..., 0], MY, MX)
    assert torch.equal(got, window_case["mask"])
    # a NaN x (tap column 0) overflows outside the first tile column only
    x_nan = torch.isnan(grid[..., 0])
    cols = torch.arange(WW)[None, None, :].expand_as(x_nan)
    assert got[x_nan & (cols >= 128)].all() and (x_nan & (cols >= 128)).any()
    assert (x_nan & (cols < 128) & ~got).any()


def test_window_ref_matches_tpu_body_on_nonfinite(window_case):
    """The body alone: NaN where the TPU body's selection product meets a
    NaN weight in the window, within one bf16 ulp elsewhere."""
    grid = window_case["grid"]
    got = ws.warp_window_ref(window_case["feat"], grid[..., 1], grid[...,
                                                                     0],
                             MY, MX)
    want = window_case["body"].to(torch.bfloat16)
    assert torch.equal(got.isnan(), want.isnan())
    assert got.isnan().any()
    ok = ~want.isnan()
    assert ws.bf16_ulps(got[ok], want[ok]).max().item() <= 1


def test_windowed_ref_matches_tpu_wrapper_on_nonfinite(window_case):
    """warp_bilinear_windowed_ref against warp_bilinear_pallas: every
    pixel with a NaN coordinate NaN in every channel on both sides;
    in-window pixels within one bf16 ulp; overflow pixels, the exact warp
    on both sides, within test_torch_warp's bf16 bound."""
    nchw = window_case["feat"].permute(0, 3, 1, 2)
    grid = window_case["grid"]
    got = ws.warp_bilinear_windowed_ref(nchw, grid, MY, MX) \
        .permute(0, 2, 3, 1)
    want = window_case["whole"].permute(0, 2, 3, 1).to(torch.bfloat16)
    px_nan = window_case["px_nan"]
    assert_nan_aware(got, want, 2.0 * BF16_FLOOR, px_nan)
    ovf = window_case["mask"][..., None].expand_as(got)
    ok = ~want.isnan()
    assert ws.bf16_ulps(got[ok & ~ovf], want[ok & ~ovf]).max().item() <= 1
    assert (ok & ovf).any()
    err = (got[ok & ovf].float() - want[ok & ovf].float()).abs().max()
    assert err.item() < BF16_FLOOR
