"""float_torch.experiments against the repository's TPU experiments on the
CPU: the windowed selection-matmul warp (K5's plain version against
``experiments/pallas_warp_selection_matmul.py``'s Pallas kernel, run in
interpret mode) and the dtype probe (K6's plain chain against
``experiments/vpu_dtype_bench.py``'s, likewise), each with controls that
must fail its gate.  Inputs come from a numpy seed at small sizes.

The kernels themselves are held to the plain versions on a card by
tests/test_torch_experiments_card.py's tests marked ``cuda`` (it imports
no JAX) and by chip_smoke.py."""
import functools
import importlib.util
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from float_torch.experiments import fma_dtype_bench as fb
from float_torch.experiments import warp_selection_matmul as ws
from float_torch.kernels import LAUNCHES
from float_torch.ops.warp import grid_sample_bilinear_ref
from test_torch_warp import BF16_FLOOR, make_grid
from torch_parity import randn

REPO = Path(__file__).resolve().parents[1]
B, H, W, C = 2, 128, 128, 16
MY, MX = 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's thread pool only oversubscribes the CPU under
    the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interpret(mod) -> None:
    """Point ``mod``'s ``pl`` at a copy of the Pallas namespace whose
    pallas_call runs in interpret mode (the module file is not edited)."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    return spec, mod


@pytest.fixture(scope="module")
def tpu_warp():
    """experiments/pallas_warp_selection_matmul.py loaded as
    float_tpu.ops.pallas.pallas_warp_selection_matmul (so that its
    ``from ..warp import`` resolves), its kernel in interpret mode."""
    name = "float_tpu.ops.pallas.pallas_warp_selection_matmul"
    spec, mod = _load(name, REPO / "experiments" /
                      "pallas_warp_selection_matmul.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, name, mod)
        spec.loader.exec_module(mod)
        _interpret(mod)
        yield mod


@pytest.fixture(scope="module")
def case(tpu_warp):
    """bf16 maps (B, H, W, C) and grids with flows of up to 12 px, zoomed
    so that some taps leave the image: both in-window and overflow pixels;
    and the TPU side's outputs."""
    rng = np.random.default_rng(8)
    feat = torch.from_numpy(randn(rng, B, H, W, C)).to(torch.bfloat16)
    grid = torch.from_numpy(make_grid(rng, B, H, W, 12.0, 1.1))
    gy, gx = grid[..., 1], grid[..., 0]
    jfeat = jnp.asarray(feat.float().numpy()).astype(jnp.bfloat16)
    jgrid = jnp.asarray(grid.numpy())
    body = tpu_warp._warp_pallas_nhwc(jfeat, jgrid[..., 1], jgrid[..., 0],
                                      MY, MX)
    whole = tpu_warp.warp_bilinear_pallas(jnp.transpose(jfeat, (0, 3, 1, 2)),
                                          jgrid, MY, MX)
    ovf = ws.overflow_mask(H, W, gy, gx, MY, MX)
    assert 0 < int(ovf.sum()) < ovf.numel() // 2
    return dict(feat=feat, grid=grid, gy=gy, gx=gx, ovf=ovf,
                body=_to_torch(body), whole=_to_torch(whole))


def _to_torch(a, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def test_window_ref_within_one_ulp_of_tpu_body(case):
    got = ws.warp_window_ref(case["feat"], case["gy"], case["gx"], MY, MX)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, C)
    assert ws.bf16_ulps(got, case["body"]).max().item() <= 1


def test_overflow_mask_equals_tpu(tpu_warp, case):
    want = tpu_warp._overflow_mask(H, W, jnp.asarray(case["gy"].numpy()),
                                   jnp.asarray(case["gx"].numpy()), MY, MX)
    assert torch.equal(case["ovf"], torch.from_numpy(np.asarray(want)))


@pytest.mark.parametrize("h,w,my,mx", [(128, 512, 8, 64), (256, 384, 16, 8),
                                       (136, 256, 0, 0)])
def test_overflow_mask_equals_tpu_column_windows(tpu_warp, h, w, my, mx):
    """Wider maps, whose column windows move with the tile, and other
    margins (no Pallas call: the mask is plain JAX)."""
    rng = np.random.default_rng(h + w)
    grid = make_grid(rng, 1, h, w, 20.0, 1.2)
    want = tpu_warp._overflow_mask(h, w, jnp.asarray(grid[..., 1]),
                                   jnp.asarray(grid[..., 0]), my, mx)
    got = ws.overflow_mask(h, w, torch.from_numpy(grid[..., 1]),
                           torch.from_numpy(grid[..., 0]), my, mx)
    assert got.any()
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))


def test_windowed_matches_tpu_wrapper(case):
    """warp_bilinear_windowed (the plain version on CPU tensors) against
    warp_bilinear_pallas: in-window pixels within one bf16 ulp; overflow
    pixels, the exact warp on both sides (the port's in f32 sums, the
    TPU's XLA gather in bf16 arithmetic), within test_torch_warp's bf16
    bound."""
    nchw = case["feat"].permute(0, 3, 1, 2)
    before = dict(LAUNCHES)
    got = ws.warp_bilinear_windowed(nchw, case["grid"])
    assert dict(LAUNCHES) == before
    assert got.shape == (B, C, H, W) and got.dtype == torch.bfloat16
    inside = ~case["ovf"][:, None].expand_as(got)
    assert ws.bf16_ulps(got[inside], case["whole"][inside]).max().item() <= 1
    ovf = ~inside
    err = (got[ovf].float() - case["whole"][ovf].float()).abs().max().item()
    assert err < BF16_FLOOR
    exact = grid_sample_bilinear_ref(nchw, case["grid"])
    assert torch.equal(got[ovf], exact[ovf])


SHAPES = [  # (feat (B, C, H, W), grid (B, Ho, Wo, 2), bf16?)
    ((2, 16, 128, 128), (2, 128, 128, 2), True),
    ((1, 32, 512, 512), (1, 512, 512, 2), True),
    ((1, 3, 256, 384), (1, 256, 384, 2), True),
    ((1, 256, 128, 128), (1, 128, 128, 2), True),
    ((1, 200, 128, 128), (1, 128, 128, 2), True),
    ((1, 16, 128, 128), (1, 128, 128, 2), False),
    ((1, 16, 64, 128), (1, 64, 128, 2), True),
    ((1, 16, 128, 200), (1, 128, 200, 2), True),
    ((1, 16, 132, 128), (1, 132, 128, 2), True),
    ((1, 16, 128, 128), (1, 64, 64, 2), True)]


@pytest.mark.parametrize("feat_shape,grid_shape,bf16", SHAPES)
def test_supports_equals_tpu(tpu_warp, feat_shape, grid_shape, bf16):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    assert ws.supports(feat_shape, grid_shape, tdt) \
        == tpu_warp.supports(feat_shape, grid_shape, jdt)


def test_control_f32_selection_weights_fail(case):
    """Unrounded (f32) selection weights: more than one ulp off the TPU."""
    got = ws.warp_window_ref(case["feat"], case["gy"], case["gx"], MY, MX,
                             weight_dtype=torch.float32)
    assert ws.bf16_ulps(got, case["body"]).max().item() > 1


def test_control_window_shifted_one_tile_fails(case, monkeypatch):
    starts = ws.window_starts

    def shifted(h, w, my, mx, device=None):
        rs, cs = starts(h, w, my, mx, device)
        wr, _ = ws.window_size(h, w, my, mx)
        return (rs + ws.TR).clamp(0, h - wr), cs

    monkeypatch.setattr(ws, "window_starts", shifted)
    got = ws.warp_window_ref(case["feat"], case["gy"], case["gx"], MY, MX)
    assert ws.bf16_ulps(got, case["body"]).max().item() > 1


# ---------------------------------------------------------------------------
# K6: the dtype probe
# ---------------------------------------------------------------------------

VARIANTS = {"f32_f32": (torch.float32, torch.float32),
            "bf16_f32": (torch.bfloat16, torch.float32),
            "bf16_bf16": (torch.bfloat16, torch.bfloat16)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def tpu_probe():
    """experiments/vpu_dtype_bench.py in interpret mode at TILES = 2."""
    spec, mod = _load("vpu_dtype_bench",
                      REPO / "experiments" / "vpu_dtype_bench.py")
    spec.loader.exec_module(mod)
    _interpret(mod)
    mod.TILES = 2
    return mod


class _Ref:
    """A Pallas ref stand-in over a JAX array, for calling a kernel body
    eagerly."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, v):
        self.a = self.a.at[idx].set(v)


def _probe_x(dtype) -> torch.Tensor:
    return torch.from_numpy(randn(np.random.default_rng(9), 2, 8, 128, 128)) \
        .to(dtype)


def _jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(JNP[x.dtype])


def _body_op_by_op(probe, dtype, acc, x: torch.Tensor) -> torch.Tensor:
    """The probe's own kernel body (``make``'s ``kern``) on each of x's
    tiles, every JAX op run on its own.  Inside one jitted computation
    XLA:CPU contracts ``acc + x * k`` into an FMA, which rounds once
    (``test_interpret_mode_contracts_on_the_cpu``); op by op each
    multiply and add is rounded, as on the TPU."""
    run = probe.make(JNP[dtype], JNP[acc]).__wrapped__
    kern = dict(zip(run.__code__.co_freevars,
                    (c.cell_contents for c in run.__closure__)))["kern"]
    tiles = []
    for i in range(x.shape[0]):
        out = _Ref(jnp.zeros((1, *fb.TILE), JNP[dtype]))
        kern(_Ref(_jax(x[i:i + 1])), out)
        tiles.append(out.a)
    return _to_torch(jnp.concatenate(tiles), dtype)


def _fused_chain(x: torch.Tensor) -> torch.Tensor:
    """The f32 chain with fused multiply-adds: one rounding a step (the
    product and sum exact in float64, then rounded to f32)."""
    xd = x.double()
    acc = x
    for k in fb.constants(torch.float32).double():
        acc = (acc.double() + xd * k).float()
    return acc


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chain_matches_tpu_probe(tpu_probe, variant):
    """f32 accumulators bit for bit; a bf16 accumulator within one ulp (a
    torch bf16 op rounds its f32 result, the TPU's the exact one)."""
    dtype, acc = VARIANTS[variant]
    x = _probe_x(dtype)
    want = _body_op_by_op(tpu_probe, dtype, acc, x)
    before = dict(LAUNCHES)
    got = fb.make(dtype, acc)(x)
    assert dict(LAUNCHES) == before
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, fb.fma_chain_ref(x, acc))
    if acc == torch.float32:
        assert torch.equal(got, want)
    else:
        assert ws.bf16_ulps(got, want).max().item() <= 1
    if dtype == torch.bfloat16:   # the bf16 outputs hide the contraction
        interp = _to_torch(tpu_probe.make(JNP[dtype], JNP[acc])(_jax(x)),
                           dtype)
        assert ws.bf16_ulps(got, interp).max().item() <= 1


def test_interpret_mode_contracts_on_the_cpu(tpu_probe):
    """make(...) in interpret mode is one XLA:CPU computation, which fuses
    each f32 multiply-add: its output is the fused chain, bit for bit,
    and not the op-by-op one."""
    x = _probe_x(torch.float32)
    interp = _to_torch(tpu_probe.make(jnp.float32, jnp.float32)(_jax(x)),
                       torch.float32)
    assert torch.equal(interp, _fused_chain(x))
    assert not torch.equal(interp, fb.fma_chain_ref(x, torch.float32))


def test_control_fused_chain_fails(tpu_probe):
    """The f32 chain with fused multiply-adds fails the bit-for-bit gate."""
    x = _probe_x(torch.float32)
    want = _body_op_by_op(tpu_probe, torch.float32, torch.float32, x)
    assert not torch.equal(_fused_chain(x), want)


def test_constants_round_as_the_tpu_probe():
    for acc in (torch.float32, torch.bfloat16):
        want = [float(JNP[acc](0.5 + i * 1e-3)) for i in range(fb.LONG_OPS)]
        assert fb.constants(acc, fb.LONG_OPS).float().tolist() == want


