"""K7 (``kernels/csrc/styled_tail.cu``): the synthesis' StyledConv tails and
skip upsamplings.

On the CPU: the dispatchers run today's op sequence bit for bit, the
synthesis routes each of its tails and skips through them, and the
arithmetic K7 encodes (the up tail's separable taps over a ring of row
sums, the skip's polyphase taps) equals the plain ops.  On a card: K7
against its plain version in f32 at every call of a config-1 decode chunk
and every frame batch the paths give it, NaN where the plain version has
NaN, and one 24-frame chunk with its 27 launches.  Imports neither JAX
nor float_tpu, so the card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_styled_tail.py``."""
import math

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from float_torch.kernels import LAUNCHES
from float_torch.kernels import styled_tail as k7
from float_torch.models import init as t_init
from float_torch.models import synthesis as t_syn
from float_torch.ops import activations, modulated, tails, upfirdn

CL = torch.channels_last
SMALL = {4: 32, 8: 32, 16: 32, 32: 32, 64: 32}
TAPS = (0.25, 0.75, 0.75, 0.25)   # (1, 3, 3, 1) / 4 a side, the up-2 gain


def rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def as_layout(t, layout):
    return t.contiguous(memory_format=CL) if layout == "cl" else t


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["nchw", "cl"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("up", [False, True])
def test_styled_conv2d_on_cpu_is_todays_sequence(up, dtype, layout):
    """A CPU StyledConv runs modulated_conv2d then fused_leaky_relu, the
    ops it ran before K7, bit for bit."""
    gen = torch.Generator().manual_seed(int(up) * 4 + (dtype == torch.float32))
    x = as_layout(rand(gen, 2, 16, 9, 9, dtype=dtype), layout)
    style = rand(gen, 2, 24, dtype=dtype)
    w = rand(gen, 1, 8, 16, 3, 3, dtype=dtype)
    mw = rand(gen, 16, 24, dtype=dtype)
    mb = torch.ones(16, dtype=dtype)
    bias = rand(gen, 8, dtype=dtype, scale=0.5)
    got = modulated.styled_conv2d(x, style, w, mw, mb, bias, up=up)
    want = activations.fused_leaky_relu(
        modulated.modulated_conv2d(x, style, w, mw, mb, demodulate=True,
                                   up=up), bias)
    assert got.shape == want.shape == (2, 8, 18 if up else 9, 18 if up else 9)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["nchw", "cl"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["rgb", "flow", "rgb_first", "flow_first"])
def test_skip_tail_on_cpu_is_todays_sequence(kind, dtype, layout):
    """ToRGB's fused_leaky_relu, the bias and upsample2x(skip) (ToFlow's
    without the activation; a first level without the skip), bit for
    bit as _rgb_tail and _flow_pred ran them before K7."""
    gen = torch.Generator().manual_seed(len(kind) + (dtype == torch.float32))
    x = as_layout(rand(gen, 2, 3, 16, 16, dtype=dtype), layout)
    skip = None if kind.endswith("first") else \
        as_layout(rand(gen, 2, 3, 8, 8, dtype=dtype), layout)
    bias = rand(gen, 1, 3, 1, 1, dtype=dtype, scale=0.5)
    act = rand(gen, 1, 3, 1, 1, dtype=dtype, scale=0.5)
    rgb = kind.startswith("rgb")
    got = tails.skip_tail(x, skip, bias.reshape(-1),
                                act.reshape(-1) if rgb else None)
    want = activations.fused_leaky_relu(x, act.reshape(-1)) if rgb else x
    want = want + bias.reshape(1, 3, 1, 1).to(want.dtype)
    if skip is not None:
        want = want + upfirdn.upsample2x(skip)
    assert torch.equal(got, want)


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 4, 4).contiguous(memory_format=CL)
    with pytest.raises(TypeError, match="CUDA"):
        k7.styled_tail_cuda(x, torch.ones(1, 8), torch.zeros(8), up=False)
    with pytest.raises(TypeError, match="CUDA"):
        k7.skip_tail_cuda(x, torch.zeros(1, 8, 2, 2), torch.zeros(8))


def up_tail_mirror(x, demod, bias):
    """The up tail as K7 sums it, in f32: each input row's four columns
    (xi = xo - 1 + j, tap j), then four row sums (yi = yo - 1 + r, tap r),
    zero outside the map."""
    b, c, hi, wi = x.shape
    ho, wo = hi - 1, wi - 1
    xp = F.pad(x.float(), (1, 1, 1, 1))          # row/column -1 and Hi
    rows = sum(TAPS[j] * xp[:, :, :, j:j + wo] for j in range(4))
    s = sum(TAPS[r] * rows[:, :, r:r + ho, :] for r in range(4))
    v = s * demod[:, :, None, None] + bias.float()[None, :, None, None]
    return torch.where(v >= 0, v, v * 0.2) * math.sqrt(2.0)


def skip_mirror(x, skip, bias, act_bias):
    """The skip mode as K7 indexes it: output row yo reads skip rows
    ys, ys + 1 with ys = yo // 2 - 1 + yo % 2, weights TAPS[2 dy + yo % 2]
    (the same across), a skip pixel outside the map adding nothing."""
    b, c, ho, wo = x.shape
    hs, ws = ho // 2, wo // 2
    v = x.float()
    if act_bias is not None:
        v = v + act_bias.float()[None, :, None, None]
        v = torch.where(v >= 0, v, v * 0.2) * math.sqrt(2.0)
    v = v + bias.float()[None, :, None, None]
    up = torch.zeros_like(v)
    yo = torch.arange(ho)
    xo = torch.arange(wo)
    for dy in range(2):
        iy = yo // 2 - 1 + yo % 2 + dy
        wy = torch.tensor(TAPS)[2 * dy + yo % 2]
        for dx in range(2):
            ix = xo // 2 - 1 + xo % 2 + dx
            wx = torch.tensor(TAPS)[2 * dx + xo % 2]
            ok = (iy >= 0)[:, None] & (iy < hs)[:, None] \
                & (ix >= 0)[None, :] & (ix < ws)[None, :]
            tap = skip.float()[:, :, iy.clamp(0, hs - 1)][
                :, :, :, ix.clamp(0, ws - 1)]
            up = up + torch.where(ok, (wy[:, None] * wx[None, :]) * tap, 0.0)
    return v + up


@pytest.mark.parametrize("hw", [(5, 5), (9, 9), (17, 9), (2, 3)])
def test_up_tail_arithmetic_equals_plain(hw):
    """K7's up tail (the 4x4 blur as two passes of (1, 3, 3, 1) / 4 over a
    pad of one) equals demodulation, upfirdn2d at pad (1, 1) and
    fused_leaky_relu, on odd, even and non-square conv outputs."""
    gen = torch.Generator().manual_seed(sum(hw))
    x = rand(gen, 2, 8, *hw)
    demod = torch.rand(2, 8, generator=gen) + 0.5
    bias = rand(gen, 8, scale=0.5)
    want = tails.styled_tail_ref(x, demod, bias, (1, 1))
    got = up_tail_mirror(x, demod, bias)
    assert got.shape == want.shape == (2, 8, hw[0] - 1, hw[1] - 1)
    assert (got - want).abs().max() <= 1e-6 * x.abs().max()


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("hw", [(16, 16), (8, 4), (2, 2)])
def test_skip_arithmetic_equals_plain(hw, act):
    """K7's polyphase skip (2x2 skip pixels an output pixel) equals
    upsample2x's zero-insert, pad (2, 1) and 4x4 blur, with ToRGB's
    activation and without it (ToFlow's)."""
    gen = torch.Generator().manual_seed(hw[0] + hw[1] + act)
    x = rand(gen, 2, 3, *hw)
    skip = rand(gen, 2, 3, hw[0] // 2, hw[1] // 2)
    bias = rand(gen, 3, scale=0.5)
    act_bias = rand(gen, 3, scale=0.5) if act else None
    want = tails.skip_tail_ref(x, skip, bias, act_bias)
    got = skip_mirror(x, skip, bias, act_bias)
    assert (got - want).abs().max() <= 1e-6 * max(x.abs().max(),
                                                  skip.abs().max())


def small_synthesis(monkeypatch, size=64, b=2, dtype=torch.float32):
    """init_synthesis(size) with 32 channels at every level, batch-1 skip
    maps and b latents, channels_last as the decode holds them."""
    monkeypatch.setattr(t_init, "CHANNELS_MAP", SMALL)
    params = t_init.ParamTree(t_init.init_synthesis(size, 32, 20, seed=3))
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(size)
    levels = [2 ** k for k in range(3, int(math.log2(size)) + 1)]
    feats = [rand(gen, 1, 32, s, s, dtype=dtype, scale=0.5)
             .contiguous(memory_format=CL) for s in levels]
    wa = rand(gen, b, 32, dtype=dtype, scale=0.3)
    return params.to(dtype), wa, feats


def test_synthesis_routes_every_tail_through_k7(monkeypatch):
    """With K7 and K8 taking every map, a 64² synthesis (4 levels) sends
    its 4 x 4 - 1 = 15 tails and skips (27 at 512², 7 levels) to K7's
    wrappers and its 4 flow merges (7 at 512²) to K8's, every up tail and
    every merge but the last with the next conv's modulation, every plain
    tail after conv1's but the last with ToFlow's as a second output (the
    last one's only output, since nothing reads the map), and arguments
    whose plain version is today's decode: here the wrappers run the plain
    versions, and the frames equal the plain synthesis bit for bit."""
    from float_torch.kernels import flow_merge as k8
    params, wa, feats = small_synthesis(monkeypatch)
    with torch.inference_mode():
        want, _ = t_syn.synthesis(params, wa, feats, 64)
    calls = []

    def fake_tail(x, demod, bias, up, scale=None, scale2=None):
        calls.append(("up" if up else "plain", x.shape[1],
                      scale is not None, scale2 is not None))
        return tails.styled_tail_ref(x, demod, bias, (1, 1) if up else None,
                                     scale=scale, scale2=scale2)

    def fake_skip(x, skip, bias, act_bias=None):
        calls.append(("rgb" if act_bias is not None else "flow", x.shape[1],
                      False, False))
        return tails.skip_tail_ref(x, skip, bias, act_bias)

    def fake_merge(warped, out, x=None, scale=None):
        calls.append(("merge", warped.shape[1], scale is not None, False))
        return tails.flow_merge_ref(warped, out, x, scale)

    monkeypatch.setattr(tails, "_on_card", lambda *a: True)
    monkeypatch.setattr(k7, "styled_tail_cuda", fake_tail)
    monkeypatch.setattr(k7, "skip_tail_cuda", fake_skip)
    monkeypatch.setattr(k8, "flow_merge_cuda", fake_merge)
    with torch.inference_mode():
        got, _ = t_syn.synthesis(params, wa, feats, 64)
    assert torch.equal(got, want)
    n = 4
    modes = [m for m, *_ in calls]
    assert len(calls) == 4 * n - 1 + n
    assert modes.count("up") == n
    assert modes.count("plain") == n + 1
    assert modes.count("merge") == n
    assert sorted(m for m, c, *_ in calls if c == 3) == \
        ["flow"] * 3 + ["rgb"] * 3
    # conv1's tail and each up tail: one output, modulated; each level's
    # plain tail: its map and ToFlow's input, the last level's ToFlow's
    # input alone (its merge is dead); each merge but the last
    assert [(m, s, s2) for m, _c, s, s2 in calls if m != "merge"
            and _c != 3] == [("plain", True, False)] + [
        ("up", True, False), ("plain", False, True)] * (n - 1) + [
        ("up", True, False), ("plain", True, False)]
    assert [s for m, _c, s, _ in calls if m == "merge"] == \
        [True] * (n - 1) + [False]
    assert len(chip_smoke.K7_CALLS) == 4 * 7 - 1


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # the plain f32 blur
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def check_k7(got, want, x, dtype):
    """K7's output: x's dtype, channels_last, within ``k7_error``'s
    tolerance of the plain version in f32, NaN at exactly its NaN
    elements."""
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
    assert chip_smoke.k7_error(got, want, x) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [24, 12, 8, 1])
@pytest.mark.parametrize("call", chip_smoke.K7_CALLS,
                         ids=[f"{m}{s}c{c}" for m, s, c in chip_smoke.K7_CALLS])
def test_k7_matches_plain(cuda_device, call, b, dtype):
    """Every K7 call of a config-1 decode chunk (conv1's 4² tail, each
    level's up tail on its odd (2H + 1)² map and plain tail, the 3-channel
    skips) at the paths' frame batches, in the decode's bf16 and the
    Very Advanced tier's f32."""
    mode, size, c = call
    gen = torch.Generator(device=cuda_device).manual_seed(size * 7 + c + b)
    fused, _, plain32, x = chip_smoke.k7_case(gen, mode, size, c, b, dtype)
    before = LAUNCHES[k7.NAME]
    got = fused()
    assert LAUNCHES[k7.NAME] == before + 1
    assert got.shape == (b, c, size, size)
    check_k7(got, plain32(), x, dtype)


TAILS = [call for call in chip_smoke.K7_CALLS if call[0] in ("up", "plain")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b", [(torch.bfloat16, 24),
                                     (torch.bfloat16, 12),
                                     (torch.float32, 8)])
@pytest.mark.parametrize("call", TAILS,
                         ids=[f"{m}{s}c{c}" for m, s, c in TAILS])
def test_k7_writes_the_next_modulation(cuda_device, call, b, dtype):
    """The modulations the decode has K7 write: conv1's tail and every up
    tail their output times the next conv's scale, every level's plain
    tail its output and, as a second output, ToFlow's modulated input;
    one launch each, both outputs channels_last in x's dtype and within
    one rounding of the plain version in f32."""
    mode, size, c = call
    epilogue = chip_smoke.k7_epilogue(mode, size)
    gen = torch.Generator(device=cuda_device).manual_seed(size * 3 + c + b)
    fused, _, plain32, x = chip_smoke.k7_case(gen, mode, size, c, b, dtype,
                                              epilogue)
    before = LAUNCHES[k7.NAME]
    got = fused()
    assert LAUNCHES[k7.NAME] == before + 1
    outs = got if epilogue == "scale2" else (got,)
    assert len(outs) == (2 if epilogue == "scale2" else 1)
    for g in outs:
        assert g.shape == (b, c, size, size) and g.dtype == dtype
        assert g.is_contiguous(memory_format=CL)
    assert chip_smoke.outputs_error(got, plain32(), x) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode,size,c", [("up", 64, 256), ("plain", 64, 256),
                                         ("up", 32, 12), ("plain", 16, 5),
                                         ("rgb", 64, 3), ("flow", 64, 3)])
def test_k7_nan_and_odd_channels(cuda_device, mode, size, c, dtype):
    """NaN and infinite inputs: NaN wherever the plain version has NaN (an
    up tail spreads one NaN over its 4x4 neighbourhood), the rest within
    tolerance; channel counts that fill no 16-byte vector (C = 12 in bf16,
    5) take one channel a thread."""
    gen = torch.Generator(device=cuda_device).manual_seed(size + c)
    fused, _, plain32, x = chip_smoke.k7_case(gen, mode, size, c, 2, dtype)
    flat = x.permute(0, 2, 3, 1).view(-1)        # x's own storage
    flat[::997] = float("nan")
    flat[5::1999] = float("inf")
    want = plain32()
    assert want.isnan().any()
    check_k7(fused(), want, x, dtype)


@pytest.mark.cuda
def test_decode_chunk_launches_k7_27_times(cuda_device, monkeypatch):
    """One 24-frame bf16 chunk of config 1: K7 launches 27 times, K8 7
    times (the last level's without a merged map), and no blur kernel is
    made (so no host-to-device copy of its taps); its frames lie within
    the bf16 decode tolerance of the plain float32 decode, and closer to
    it on average than the plain bf16 decode's."""
    from float_torch.kernels import flow_merge as k8
    from float_torch.runtime.decode import decode_chunk
    p32 = t_init.ParamTree(t_init.init_synthesis(512)).to(cuda_device)
    p16 = t_init.ParamTree(t_init.init_synthesis(512)).to(cuda_device) \
        .to(torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    f32 = [torch.randn((1, c, s, s), generator=gen, device=cuda_device)
           .contiguous(memory_format=CL) for s, c in chip_smoke.LEVELS]
    f16 = [f.to(torch.bfloat16) for f in f32]
    wa = torch.randn((24, 512), generator=gen, device=cuda_device)
    made = []
    real = upfirdn.make_blur_kernel
    for mod in (upfirdn, modulated, tails):
        monkeypatch.setattr(mod, "make_blur_kernel",
                            lambda *a, **k: made.append(a) or real(*a, **k))
    before = LAUNCHES[k7.NAME], LAUNCHES[k8.NAME], LAUNCHES[k8.NAME_LAST]
    with torch.inference_mode():
        got = decode_chunk(p16, wa.to(torch.bfloat16), f16, 512)
    assert (LAUNCHES[k7.NAME] - before[0], LAUNCHES[k8.NAME] - before[1],
            LAUNCHES[k8.NAME_LAST] - before[2]) == (27, 6, 1)
    assert made == []
    monkeypatch.setattr(tails, "_on_card", lambda *a: False)
    with torch.inference_mode():
        plain = decode_chunk(p16, wa.to(torch.bfloat16), f16, 512)
        ref = decode_chunk(p32, wa, f32, 512)
    assert made
    err, err_plain = (got - ref).abs(), (plain - ref).abs()
    assert err.max().item() <= chip_smoke.BF16_DECODE_TOL
    assert err.mean().item() <= err_plain.mean().item()
