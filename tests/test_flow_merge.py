"""K8 (``kernels/csrc/flow_merge.cu``): a decode level's flow merge, and
the synthesis that has every modulation written by the op that makes its
input.

On the CPU: the synthesis' frames equal float_tpu's op sequence (each
StyledConv modulating its own input, the merge's mask, products and sum,
the merged map formed at the last level too) bit for bit, and the
dispatcher runs the plain version.  On a card: K8 against its plain
version in f32 from the same inputs, within one bf16 rounding, at every
level of a config-1 decode chunk, in f32 at 8 frames, on K1's and K3's
warps, with and without the next conv's modulation, on a mask of any
value and on a saturated one.  Imports neither JAX nor float_tpu, so the
card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_flow_merge.py``."""
import math

import pytest
import torch

import chip_smoke
from float_torch.kernels import LAUNCH_SHAPES, LAUNCHES
from float_torch.kernels import flow_merge as k8
from float_torch.models import init as t_init
from float_torch.models import synthesis as t_syn
from float_torch.ops import (PLAIN, equal_conv2d, identity_grid,
                             modulated_conv2d, skip_tail_ref, styled_conv2d,
                             tails)

CL = torch.channels_last
SMALL = {4: 32, 8: 32, 16: 32, 32: 32, 64: 32}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def todays_synthesis(params, wa, feats, size, rgb_in_kernel=False):
    """The synthesis in float_tpu's order of ops: each StyledConv and
    ToFlow modulating its own input, the mask made with the flow, the
    merged map formed at every level, the plain warps."""
    dtype, b = wa.dtype, wa.shape[0]
    n_levels = int(math.log2(size)) - 2
    nhwc = [f.to(dtype).contiguous(memory_format=CL).permute(0, 2, 3, 1)
            for f in feats]

    def styled(x, p, up):
        return styled_conv2d(
            x, wa, p["conv"]["weight"], p["conv"]["modulation"]["weight"],
            p["conv"]["modulation"]["bias"],
            p["activate"]["bias"].reshape(-1), up=up)

    def flow_pred(x, p, skip):
        out = modulated_conv2d(
            x, wa, p["conv"]["weight"], p["conv"]["modulation"]["weight"],
            p["conv"]["modulation"]["bias"], demodulate=False)
        out = tails.skip_tail(out, skip, p["bias"].reshape(-1))
        sampler = torch.tanh(out[:, 0:2].float())
        mask = torch.sigmoid(out[:, 2:3].float()).to(x.dtype)
        flow = (sampler.permute(0, 2, 3, 1)
                + identity_grid(x.shape[2], device=x.device)).contiguous()
        return out, flow, mask

    def rgb_tail(x, p, skip):
        return skip_tail_ref(x, skip, p["bias"].reshape(-1),
                             act_bias=p["conv"]["1"]["bias"].reshape(-1))

    out = params["input"]["input"].to(dtype).expand(b, -1, -1, -1) \
        .contiguous(memory_format=CL)
    out = styled(out, params["conv1"], False)
    skip = skip_flow = None
    for lvl in range(n_levels):
        out = styled(out, params["convs"][str(2 * lvl)], True)
        out = styled(out, params["convs"][str(2 * lvl + 1)], False)
        out = out.contiguous(memory_format=CL)
        feat, p_flow = nhwc[lvl], params["to_flows"][str(lvl)]
        p_rgb = params["to_rgbs"][str(lvl)]
        shared = feat.shape[0] == 1 and b != 1
        if rgb_in_kernel and lvl == n_levels - 1 and shared:
            _raw, flow, mask = flow_pred(out, p_flow, skip_flow)
            w0 = p_rgb["conv"]["0"]["weight"].float()
            wk = (w0[:, :, 0, 0] * (1.0 / math.sqrt(feat.shape[-1])))
            rgb = PLAIN.rgb(feat, flow, wk.contiguous()).permute(0, 3, 1, 2)
            skip = rgb_tail(rgb * mask, p_rgb, skip)
            continue
        skip_flow, flow, mask = flow_pred(out, p_flow, skip_flow)
        warp = PLAIN.shared if shared else PLAIN.per_frame
        warped = warp(feat, flow).permute(0, 3, 1, 2)
        feat_warp = warped * mask
        out = feat_warp + out * (1.0 - mask)
        skip = rgb_tail(equal_conv2d(feat_warp, p_rgb["conv"]["0"]["weight"]),
                        p_rgb, skip)
    return skip


@pytest.fixture(scope="module")
def small():
    mp = pytest.MonkeyPatch()
    mp.setattr(t_init, "CHANNELS_MAP", SMALL)
    try:
        return t_init.ParamTree(t_init.init_synthesis(64, 32, 20, seed=5))
    finally:
        mp.undo()


@pytest.mark.parametrize("rgb_in_kernel", [False, True])
@pytest.mark.parametrize("maps", ["shared", "per_frame", "one_frame"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_synthesis_on_cpu_is_todays_sequence(small, dtype, maps,
                                             rgb_in_kernel):
    """The CPU frames equal float_tpu's op sequence bit for bit: batch-1
    maps under 2 frames (K1's levels, K2's last with ``rgb_in_kernel``),
    maps of batch 2 and one frame (K3's)."""
    gen = torch.Generator().manual_seed(len(maps) + rgb_in_kernel)
    b = 1 if maps == "one_frame" else 2
    fb = 2 if maps == "per_frame" else 1
    feats = [(torch.randn((fb, 32, s, s), generator=gen) * 0.5).to(dtype)
             .contiguous(memory_format=CL) for s in (8, 16, 32, 64)]
    wa = (torch.randn((b, 32), generator=gen) * 0.3).to(dtype)
    params = small.to(dtype)
    with torch.inference_mode():
        got, _ = t_syn.synthesis(params, wa, feats, 64,
                                 rgb_in_kernel=rgb_in_kernel)
        want = todays_synthesis(params, wa, feats, 64, rgb_in_kernel)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_on_cpu_is_todays_sequence(dtype, scaled):
    """On CPU tensors the dispatcher runs the plain version: the mask
    sigmoid(out.z) in the map's dtype, warped * mask, and feat_warp +
    x * (1 - mask) times the next conv's modulation, bit for bit."""
    gen = torch.Generator().manual_seed(int(scaled))
    warped, x = (torch.randn((2, 8, 5, 6), generator=gen).to(dtype)
                 .contiguous(memory_format=CL) for _ in range(2))
    out = (torch.randn((2, 3, 5, 6), generator=gen) * 3).to(dtype)
    scale = (torch.rand((2, 8), generator=gen) * 0.1).to(dtype) \
        if scaled else None
    feat_warp, merged = tails.flow_merge(warped, out, x, scale)
    mask = torch.sigmoid(out[:, 2:3].float()).to(dtype)
    assert torch.equal(feat_warp, warped * mask)
    if scaled:
        want = (warped * mask + x * (1.0 - mask)) * scale[:, :, None, None]
        assert torch.equal(merged, want)
    else:
        assert merged is None


def test_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 8, 4, 4).contiguous(memory_format=CL)
    with pytest.raises(TypeError, match="flow_merge.*CUDA"):
        k8.flow_merge_cuda(x, torch.zeros(1, 3, 4, 4), x)


def k8_mirror(warped, out, x, scale):
    """K8's arithmetic in f32 as the kernel orders it: m = 1 / (1 +
    exp(-z)), feat = w * m, merged = (feat + x * (1 - m)) * s."""
    m = 1.0 / (1.0 + torch.exp(-out[:, 2:3].float()))
    feat = warped.float() * m
    return feat, (feat + x.float() * (1.0 - m)) * scale.float()[:, :, None,
                                                              None]


def test_kernel_arithmetic_equals_plain():
    """The kernel's order of operations on f32 values equals the plain
    version in f32 to within f32 rounding, a saturated mask included."""
    gen = torch.Generator().manual_seed(9)
    warped, x = (torch.randn((2, 16, 7, 7), generator=gen) for _ in range(2))
    out = torch.randn((2, 3, 7, 7), generator=gen) * 4
    out[0, 2, :3] = 40.0
    out[1, 2, :3] = -40.0
    scale = torch.rand((2, 16), generator=gen) * 0.1
    want = tails.flow_merge_ref(warped, out, x, scale)
    for g, w in zip(k8_mirror(warped, out, x, scale), want):
        assert (g - w).abs().max() <= 1e-6 * max(warped.abs().max(),
                                                 x.abs().max())


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def check_k8(k8_call, plain32, x, dtype, scaled: bool):
    """One K8 launch, counted under its name and shape; its two outputs
    of x's dtype, channels_last, within one rounding of the plain version
    in f32 (``chip_smoke.outputs_error``); no merged map without scale."""
    name = k8.NAME if scaled else k8.NAME_LAST
    b, c, h, w = x.shape
    before = LAUNCHES[name], LAUNCH_SHAPES[(name, b, h, w, c)]
    got = k8_call()
    assert (LAUNCHES[name], LAUNCH_SHAPES[(name, b, h, w, c)]) == (
        before[0] + 1, before[1] + 1)
    assert (got[1] is not None) == scaled
    for g in got:
        if g is not None:
            assert g.dtype == dtype and g.is_contiguous(memory_format=CL)
    assert chip_smoke.outputs_error(got, plain32(), x) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "call", chip_smoke.K8_CALLS,
    ids=[f"{m}{s}c{c}" for m, s, c in chip_smoke.K8_CALLS])
def test_k8_at_each_level_of_a_chunk(cuda_device, call):
    """Every K8 call of a 24-frame bf16 chunk of config 1: the 6 merges
    with the next up conv's modulation and the last level's alone."""
    mode, size, c = call
    gen = torch.Generator(device=cuda_device).manual_seed(size + c)
    fused, _, plain32, x = chip_smoke.k8_case(gen, mode, size, c, 24,
                                              torch.bfloat16)
    check_k8(fused, plain32, x, torch.bfloat16, mode == "merge")


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["smooth", "saturated"])
@pytest.mark.parametrize("warp", ["shared", "per_frame"])
@pytest.mark.parametrize("mode", ["merge", "last"])
@pytest.mark.parametrize("dtype,b", [(torch.bfloat16, 24),
                                     (torch.float32, 8)])
def test_k8_on_each_warp_and_mask(cuda_device, dtype, b, mode, warp, mask):
    """K1's and K3's warps, both modes, a mask of any value and one of 0
    and 1, in the decode's bf16 and the Very Advanced tier's f32 (8-frame
    chunks), at the 64² level (C = 256) and the 512² level (C = 32)."""
    for size, c in ((64, 256), (512, 32)):
        gen = torch.Generator(device=cuda_device).manual_seed(size + b)
        fused, _, plain32, x = chip_smoke.k8_case(gen, mode, size, c, b,
                                                  dtype, warp, mask)
        check_k8(fused, plain32, x, dtype, mode == "merge")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8_odd_channels_and_strided_mask(cuda_device, dtype):
    """A channel count that fills no 16-byte vector takes one channel a
    thread, and ToFlow's raw output in NCHW memory is read through its
    strides."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    warped, x = (torch.randn((3, 12, 9, 10), generator=gen,
                             device=cuda_device).to(dtype)
                 .contiguous(memory_format=CL) for _ in range(2))
    out = torch.randn((3, 3, 9, 10), generator=gen, device=cuda_device) \
        .to(dtype) * 3
    scale = (torch.rand((3, 12), generator=gen, device=cuda_device)
             * 0.1).to(dtype)
    check_k8(lambda: tails.flow_merge(warped, out, x, scale),
             lambda: tails.flow_merge_ref(warped.float(), out.float(),
                                          x.float(), scale.float()),
             x, dtype, True)
