"""K9 (``kernels/csrc/fmt_block.cu``): an FMT block's non-GEMM passes, and
the FMT whose linears are bias-free products with those passes between
them (``models.fmt``, ``ops.fmt_block``).

On the CPU: the FMT's forward with the plain passes and silu(c) made once
a forward equals the op sequence it had before (``_before_forward``, a
frozen copy: biased linears, silu(c) in every block) bit for bit in every
CFG mode, with a dynamic we, on a tree split over model ranks, in f32 and
bf16; the dispatcher sends CPU tensors to the plain passes and card
tensors to K9, and raises for card tensors K9 does not take (f64, a
stride, a width over its rows); the wrappers raise on a wrong device,
dtype or stride; a chunk makes 1 + 4 x depth passes a forward.  On a
card: each K9 mode against its plain version in f32 at config 1's shapes
and a tiny one, and in bf16 and f16 against the plain f32 ops on the same
values, the attention's refusal of a head over a block's shared memory,
a replayed chunk's latents against the plain eager chunk, a bf16 sampler
through K9, and K9's launches a replayed chunk in each CFG mode.  Imports neither JAX nor float_tpu, so
the card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_fmt_fused.py``."""
import math
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from float_torch.config import FloatConfig
from float_torch.kernels import LAUNCHES
from float_torch.kernels import fmt_block as k9
from float_torch.models import fmt as t_fmt
from float_torch.models.init import ParamTree, init_fmt
from float_torch.ops import fmt_block as ops
from float_torch.parallel.sharding import row_parallel, shard_fmt
from float_torch.runtime import sampling

TINY = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                   dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                   num_prev_frames=3, decode_batch=4,
                   compute_dtype="float32")
C1 = FloatConfig()                   # config 1: dim_h 1024, 8 blocks
SCALES = dict(a_cfg_scale=2.0, e_cfg_scale=1.3, r_cfg_scale=0.7)


# -- the op sequence before K9, frozen -------------------------------------

def _b_linear(p, x):
    return F.linear(x, p["weight"].to(x.dtype)) + p["bias"].to(x.dtype)


def _b_layer_norm(x, eps=1e-6):
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _b_modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _b_heads(p_qkv, x, bias, heads):
    b, n, _ = x.shape
    hd = p_qkv["weight"].shape[0] // (3 * heads)
    qkv = _b_linear(p_qkv, x).reshape(b, n, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd) + bias
    att = torch.softmax(logits, dim=-1).to(x.dtype)
    return (att @ v).transpose(1, 2).reshape(b, n, heads * hd)


def _b_attention(p, x, bias, num_heads):
    shards = getattr(p, "tp_shards", None)
    if shards:
        heads = num_heads // len(shards)
        return row_parallel(shards, x, lambda s, xs: F.linear(
            _b_heads(s["qkv"], xs, bias.to(xs.device), heads),
            s["proj"]["weight"].to(xs.dtype)), p["proj"]["bias"])
    return _b_linear(p["proj"], _b_heads(p["qkv"], x, bias, num_heads))


def _b_mlp(p, x):
    shards = getattr(p, "tp_shards", None)
    if shards:
        return row_parallel(shards, x, lambda s, xs: F.linear(
            F.gelu(_b_linear(s["fc1"], xs), approximate="tanh"),
            s["fc2"]["weight"].to(xs.dtype)), p["fc2"]["bias"])
    return _b_linear(p["fc2"], F.gelu(_b_linear(p["fc1"], x),
                                      approximate="tanh"))


def _b_block(p, x, c, bias, num_heads):
    mod = _b_linear(p["adaLN_modulation"]["1"], F.silu(c))
    sm, cm, gm, sf, cf, gf = mod.chunk(6, dim=-1)
    x = x + gm * _b_attention(p["attn"], _b_modulate(_b_layer_norm(x), sm, cm),
                              bias, num_heads)
    return x + gf * _b_mlp(p["mlp"], _b_modulate(_b_layer_norm(x), sf, cf))


def _before_forward(params, t, x, wa, wr, we, prev_x, prev_wa, prev_we, *,
                    depth, num_heads, attention_window):
    dynamic = we.shape[1] > 1
    x = torch.cat([prev_x, x], dim=1)
    wa = torch.cat([prev_wa, wa], dim=1)
    total = x.shape[1]
    if dynamic:
        we = torch.cat([prev_we, we], dim=1)
    else:
        we = we.expand(we.shape[0], total, we.shape[2])
    t_emb = t_fmt._t_embedder(params["t_embedder"], t)[:, None, :]
    h = _b_linear(params["x_embedder"]["proj"], x)
    h = h + t_fmt.sinusoid_pos_embed(total, h.shape[-1],
                                     h.device).to(h.dtype)[None]
    wr_b = wr[:, None, :].expand(wr.shape[0], total, wr.shape[-1])
    c = _b_linear(params["c_embedder"],
                  torch.cat([wr_b, wa, we.to(wa.dtype)], dim=-1))
    c = t_emb.to(c.dtype) + c
    bias = t_fmt.alignment_bias(total, total, attention_window, h.device)
    for i in range(depth):
        h = _b_block(params["blocks"][str(i)], h, c, bias, num_heads)
    p = params["decoder"]
    shift, scale = _b_linear(p["adaLN_modulation"]["1"],
                             F.silu(c)).chunk(2, -1)
    return _b_linear(p["linear"],
                     _b_modulate(_b_layer_norm(h), shift, scale))


# -- helpers -----------------------------------------------------------------

def _fmt(cfg, seed, device="cpu"):
    """An FMT tree with every weight and bias drawn (init_fmt's biases are
    zeros, its adaLN small: the passes' every term should count)."""
    tree = ParamTree(init_fmt(cfg, seed=seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in tree.named_parameters():
            scale = 1.0 / math.sqrt(p.shape[-1]) if p.ndim == 2 else 0.1
            p.copy_(scale * torch.randn(p.shape, generator=g))
    return tree.to(device)


def _inputs(cfg, b, dynamic, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    clip, prev = cfg.num_frames_for_clip, cfg.num_prev_frames

    def r(*shape):
        return torch.randn(shape, generator=g).to(device, dtype)
    return dict(t=torch.tensor([0.3], device=device, dtype=dtype),
                x=r(b, clip, cfg.dim_w), wa=r(b, clip, cfg.dim_a),
                wr=r(b, cfg.dim_w),
                we=r(b, clip if dynamic else 1, cfg.dim_e),
                prev_x=r(b, prev, cfg.dim_w), prev_wa=r(b, prev, cfg.dim_a),
                prev_we=r(b, prev, cfg.dim_e) if dynamic else None)


def _kw(cfg, mode):
    return dict(SCALES, cfg_mode=mode, include_r_cfg=mode == "4way",
                depth=cfg.fmt_depth, num_heads=cfg.num_heads,
                attention_window=cfg.attention_window)


# -- on the CPU --------------------------------------------------------------

CASES = {"3way": ("3way", False, 0, torch.float32),
         "4way": ("4way", False, 0, torch.float32),
         "skip": ("skip", False, 0, torch.float32),
         "dynamic_we": ("3way", True, 0, torch.float32),
         "tp_shards": ("3way", False, 2, torch.float32),
         "tp_shards_4way": ("4way", True, 4, torch.float32),
         "bf16": ("3way", False, 0, torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_passes_equal_the_op_sequence_before_bit_for_bit(case,
                                                               monkeypatch):
    """The CFG forward with bias-free products, the plain passes and
    silu(c) made once, against the same forward with the block's old op
    sequence swapped in: equal bit for bit."""
    mode, dynamic, ranks, dtype = CASES[case]
    tree = _fmt(TINY, seed=4)
    if ranks:
        assert shard_fmt(tree, [torch.device("cpu")] * ranks,
                         TINY.num_heads) == 2 * TINY.fmt_depth
    tree = tree.to(dtype) if dtype != torch.float32 else tree
    args = _inputs(TINY, 1, dynamic, seed=7, dtype=dtype)
    with torch.inference_mode():
        got = t_fmt.fmt_forward_cfg(tree, **args, **_kw(TINY, mode))
        monkeypatch.setattr(t_fmt, "fmt_forward", _before_forward)
        want = t_fmt.fmt_forward_cfg(tree, **args, **_kw(TINY, mode))
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _fake(device="cuda", dtype=torch.float32, shape=(3, 60, 1024),
          contiguous=True):
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                           ndim=len(shape), shape=shape,
                           is_contiguous=lambda: contiguous)


DISPATCH = {
    "config1": (_fake(), 128, True),
    "four_way": (_fake(shape=(4, 60, 1024)), 128, True),
    "tiny": (_fake(shape=(1, 13, 64)), 16, True),
    "long_n_fits": (_fake(shape=(3, 200, 1024)), 128, True),
    "cpu": (_fake(device="cpu"), 128, False),
    "bf16": (_fake(dtype=torch.bfloat16), 128, True),
    "f64": (_fake(dtype=torch.float64), 128, False),
    "f16": (_fake(dtype=torch.float16), 128, True),
    # N is the attention launcher's to hold to the card's shared memory
    "n_over_smem": (_fake(shape=(3, 300, 1024)), 128, True),
    "width_not_4": (_fake(shape=(3, 60, 1022)), 128, False),
    "width_over_rows": (_fake(shape=(3, 60, 8196)), 128, False),
    "width_over_1024": (_fake(shape=(3, 60, 1028)), 128, False),
    "hd_not_4": (_fake(shape=(3, 60, 1020)), 102, False),
    "strided": (_fake(contiguous=False), 128, False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_the_dispatcher_takes_k9_only_where_it_computes_the_blocks(case):
    x, hd, takes = DISPATCH[case]
    assert ops.k9_takes(x, hd) is takes


@pytest.mark.parametrize("case", sorted(k for k in DISPATCH
                                        if DISPATCH[k][0].is_cuda))
def test_block_ops_on_a_card_takes_k9_or_raises(case, monkeypatch):
    """A card's FMT runs K9 or raises: never the plain passes."""
    x, hd, takes = DISPATCH[case]
    k9_ops = object()
    monkeypatch.setattr(ops, "_k9", lambda: k9_ops)
    if takes:
        assert ops.block_ops(x, hd) is k9_ops
    else:
        with pytest.raises(ValueError, match="K9 takes"):
            ops.block_ops(x, hd)


def test_cpu_tensors_run_the_plain_passes(monkeypatch):
    """On the CPU the forward never asks for K9."""
    def refuse():
        raise AssertionError("K9 asked for on the CPU")
    monkeypatch.setattr(ops, "_k9", refuse)
    x = torch.zeros(3, 60, 1024)
    assert ops.block_ops(x, 128) is ops.PLAIN
    with torch.inference_mode():
        t_fmt.fmt_forward_cfg(_fmt(TINY, 1), **_inputs(TINY, 1, False, 2),
                              **_kw(TINY, "3way"))


def _cpu_args(d=64, n=5, b=2, heads=4):
    g = torch.Generator().manual_seed(0)
    mod = torch.randn(b, n, 6 * d, generator=g)
    bias = torch.randn(6 * d, generator=g)
    x = torch.randn(b, n, d, generator=g)
    return dict(x=x, mod=mod.chunk(6, -1), mb=bias.chunk(6),
                qkv=torch.randn(b, n, 3 * d, generator=g),
                qkv_bias=torch.randn(3 * d, generator=g),
                table=torch.zeros(n, n), heads=heads)


WRAPPERS = {
    "ln_mod": lambda a: k9.ln_mod_cuda(a["x"], a["mod"][0], a["mb"][0],
                                       a["mod"][1], a["mb"][1]),
    "gate_res_ln_mod": lambda a: k9.gate_res_ln_mod_cuda(
        a["x"], a["x"], a["mb"][0], a["mod"][2], a["mb"][2], a["mod"][0],
        a["mb"][0], a["mod"][1], a["mb"][1]),
    "attn": lambda a: k9.attn_cuda(a["qkv"], a["qkv_bias"], a["table"],
                                   a["heads"]),
    "bias_gelu": lambda a: k9.bias_gelu_cuda(a["x"], a["mb"][0]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("mode", sorted(WRAPPERS))
def test_the_wrappers_refuse_cpu_tensors_and_other_dtypes(mode, dtype):
    a = _cpu_args()
    a = {k: v.to(dtype) if isinstance(v, torch.Tensor) else
         tuple(t.to(dtype) for t in v) if isinstance(v, tuple) else v
         for k, v in a.items()}
    with pytest.raises(TypeError):
        WRAPPERS[mode](a)


def test_the_row_checks_take_slices_and_refuse_other_strides():
    """A slice of an adaLN product is read through its row stride; a
    transposed tensor, a slice off 16 bytes, another dtype or shape is
    refused, as is a bias that is not an aligned contiguous vector."""
    mod = torch.zeros(2, 5, 6 * 64)
    shape, cpu = (2, 5, 64), torch.device("cpu")
    assert k9._rows("shift", mod.chunk(6, -1)[3], shape, cpu) == 6 * 64
    assert k9._rows("x", torch.zeros(shape), shape, cpu) == 64
    assert k9._rows("x", torch.zeros(2, 1, 64), (2, 1, 64), cpu) == 64
    half = mod.bfloat16()
    assert k9._rows("shift", half.chunk(6, -1)[3], shape, cpu,
                    torch.bfloat16) == 6 * 64
    with pytest.raises(ValueError):                  # 2 values in
        k9._rows("shift", half[..., 2:66], shape, cpu, torch.bfloat16)
    bad = {"transposed": torch.zeros(2, 64, 5).transpose(1, 2),
           "unaligned": mod[..., 1:65], "f64": torch.zeros(shape).double(),
           "shape": torch.zeros(2, 5, 60),
           "batch_gap": torch.zeros(2, 6, 64)[:, :5]}
    for name, t in bad.items():
        with pytest.raises(ValueError):
            k9._rows(name, t, shape, cpu)
    v = torch.zeros(65)
    assert k9._vector("b", v[:64], 64, cpu) is not None
    for t in (v[1:], torch.zeros(128)[::2], torch.zeros(64).double()):
        with pytest.raises(ValueError):
            k9._vector("b", t, 64, cpu)


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_the_attention_scale_is_rounded_as_pytorch_divides(hd):
    """1 / sqrt(hd) as the f32 reciprocal of sqrt(hd) rounded to f32."""
    assert k9.inv_sqrt(hd) == float(torch.tensor(1.0)
                                    / torch.tensor(math.sqrt(hd)))


def _counting(monkeypatch):
    """block_ops returning the plain passes, each call counted by K9's
    launch name."""
    n = Counter()
    names = dict(zip(ops.BlockOps._fields, (k9.LN_MOD, k9.GATE_RES_LN_MOD,
                                             k9.ATTN, k9.BIAS_GELU)))

    def counted(field):
        fn = getattr(ops.PLAIN, field)

        def call(*a, **kw):
            n[names[field]] += 1
            return fn(*a, **kw)
        return call
    wrapped = ops.BlockOps(*(counted(f) for f in ops.BlockOps._fields))
    monkeypatch.setattr(t_fmt, "block_ops", lambda *a: wrapped)
    return n


@pytest.mark.parametrize("ranks", [0, 2])
@pytest.mark.parametrize("mode", ["3way", "4way", "skip"])
def test_a_chunk_makes_one_ln_mod_and_four_passes_a_block(monkeypatch, mode,
                                                          ranks):
    """(nfe - 1) forwards a chunk, each one ln_mod, and a block's two
    gated residuals, attention and GELU (one of the last two a model
    rank); at config 1 that is 297 a chunk."""
    n = _counting(monkeypatch)
    cfg = TINY.replace(include_r_cfg=mode == "4way")
    tree = _fmt(cfg, 3)
    if ranks:
        shard_fmt(tree, [torch.device("cpu")] * ranks, cfg.num_heads)
    scales = (dict(a_cfg_scale=1.0, e_cfg_scale=1.0, r_cfg_scale=1.0)
              if mode == "skip" else SCALES)
    r_s, wa, we = (torch.randn(1, cfg.dim_w), torch.randn(1, 25, cfg.dim_a),
                   torch.rand(1, 1, cfg.dim_e))
    with torch.inference_mode():
        list(sampling.sample_motion_chunks(
            tree, r_s, wa, we, cfg=cfg, **scales,
            generator=torch.Generator().manual_seed(1)))
    chunks, steps, depth = 3, cfg.nfe - 1, cfg.fmt_depth
    per = max(ranks, 1)
    assert n == {k9.LN_MOD: chunks * steps,
                 k9.GATE_RES_LN_MOD: chunks * steps * 2 * depth,
                 k9.ATTN: chunks * steps * depth * per,
                 k9.BIAS_GELU: chunks * steps * depth * per}
    assert C1.nfe - 1 == 9 and 9 * (1 + 4 * C1.fmt_depth) == 297


# -- on a card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False    # as a pipeline sets
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# (N, D, heads, MLP width): config 1's and the tiny config's
SHAPES = {"config1": (60, 1024, 8, 4096), "tiny": (13, 64, 4, 256)}


def _mode_inputs(card, b, shape, seed, dtype=torch.float32):
    n, d, heads, hidden = shape
    g = torch.Generator(device=card).manual_seed(seed)

    def r(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g, device=card)).to(dtype)
    mod = r(b, n, 6 * d, scale=0.3)
    return dict(x=r(b, n, d), y=r(b, n, d), y_bias=r(d, scale=0.1),
                mod=mod.chunk(6, -1), mb=r(6 * d, scale=0.1).chunk(6),
                qkv=r(b, n, 3 * d), qkv_bias=r(3 * d, scale=0.1),
                table=t_fmt.alignment_bias(n, n, 2, card),
                fc1=r(b, n, hidden, scale=2.0), fc1_bias=r(hidden, scale=0.1),
                heads=heads)


def _launched(name, fn):
    before = LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    return out


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# Tolerances, each relative to max|plain| of the output.  The ln modes: the
# row's mean and variance summed in another order than PyTorch's Welford
# LayerNorm (a few f32 roundings of sums of D <= 1024 terms); everything
# after is rounded as the plain ops round it.  The attention: q.k over hd
# terms and p.v over N keys summed in other orders than cuBLAS's, the
# softmax's exp and sum as PyTorch's (about 1e-7 relative each, carried by
# a softmax whose logits are O(1)).  The GELU: tanhf against PyTorch's
# kernel's, a few f32 roundings.
LN_TOL, ATTN_TOL, GELU_TOL = 1e-5, 1e-5, 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("b", [1, 3, 4, 6])
def test_each_k9_mode_against_its_plain_version(card, b, shape):
    a = _mode_inputs(card, b, SHAPES[shape], seed=b)
    m, mb = a["mod"], a["mb"]
    got = _launched(k9.LN_MOD, lambda: k9.ln_mod_cuda(a["x"], m[0], mb[0],
                                                        m[1], mb[1]))
    assert _rel(got, ops.ln_mod_ref(a["x"], m[0], mb[0], m[1], mb[1])) \
        <= LN_TOL
    for y_bias in (a["y_bias"], None):
        args = (a["x"], a["y"], y_bias, m[2], mb[2], m[3], mb[3], m[4], mb[4])
        x1, xm = _launched(k9.GATE_RES_LN_MOD,
                           lambda: k9.gate_res_ln_mod_cuda(*args))
        w1, wm = ops.gate_res_ln_mod_ref(*args)
        assert torch.equal(x1, w1)          # rounded as the plain ops round
        assert _rel(xm, wm) <= LN_TOL
    got = _launched(k9.ATTN, lambda: k9.attn_cuda(
        a["qkv"], a["qkv_bias"], a["table"], a["heads"]))
    assert _rel(got, ops.attn_ref(a["qkv"], a["qkv_bias"], a["table"],
                                  a["heads"])) <= ATTN_TOL
    got = _launched(k9.BIAS_GELU, lambda: k9.bias_gelu_cuda(a["fc1"],
                                                            a["fc1_bias"]))
    assert _rel(got, ops.bias_gelu_ref(a["fc1"], a["fc1_bias"])) <= GELU_TOL


# A 16-bit K9 computes in f32 and rounds each output once: against the
# plain f32 ops on the same values it errs by the f32 tolerances above plus
# the output's rounding, at most the dtype's unit roundoff (2^-8 in bf16,
# 2^-11 in f16) of a value, so of max|plain|.  x' is the plain f32 x'
# rounded once, exactly.
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def _up(a: dict) -> dict:
    """``a``'s 16-bit tensors widened to f32 (the values K9 reads)."""
    return {k: v.float() if isinstance(v, torch.Tensor)
            else tuple(t.float() for t in v) if isinstance(v, tuple) else v
            for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(UNIT_ROUNDOFF))
@pytest.mark.parametrize("b", [1, 3])
def test_each_k9_mode_in_16_bit_floats(card, b, dtype, shape):
    dt, u = getattr(torch, dtype), UNIT_ROUNDOFF[dtype]
    a = _mode_inputs(card, b, SHAPES[shape], seed=20 + b, dtype=dt)
    w = _up(a)
    m, mb, wm_, wmb = a["mod"], a["mb"], w["mod"], w["mb"]
    got = _launched(k9.LN_MOD, lambda: k9.ln_mod_cuda(a["x"], m[0], mb[0],
                                                        m[1], mb[1]))
    assert got.dtype == dt
    assert _rel(got.float(), ops.ln_mod_ref(w["x"], wm_[0], wmb[0], wm_[1],
                                            wmb[1])) <= LN_TOL + u
    for bias in ("y_bias", None):
        args = (a["x"], a["y"], bias and a[bias], m[2], mb[2], m[3], mb[3],
                m[4], mb[4])
        x1, xm = _launched(k9.GATE_RES_LN_MOD,
                           lambda: k9.gate_res_ln_mod_cuda(*args))
        w1, wm = ops.gate_res_ln_mod_ref(
            w["x"], w["y"], bias and w[bias], wm_[2], wmb[2], wm_[3],
            wmb[3], wm_[4], wmb[4])
        assert torch.equal(x1, w1.to(dt))           # rounded once
        assert _rel(xm.float(), wm) <= LN_TOL + u
    got = _launched(k9.ATTN, lambda: k9.attn_cuda(
        a["qkv"], a["qkv_bias"], a["table"], a["heads"]))
    assert got.dtype == dt
    assert _rel(got.float(), ops.attn_ref(w["qkv"], w["qkv_bias"],
                                          w["table"], w["heads"])) \
        <= ATTN_TOL + u
    got = _launched(k9.BIAS_GELU, lambda: k9.bias_gelu_cuda(a["fc1"],
                                                            a["fc1_bias"]))
    assert _rel(got.float(), ops.bias_gelu_ref(w["fc1"], w["fc1_bias"])) \
        <= GELU_TOL + u


@pytest.mark.cuda
def test_the_attention_refuses_a_head_over_a_blocks_shared_memory(card):
    """300 keys and values of a 128-wide head (318 KB) do not fit a
    block: the launcher refuses, the wrapper raises, nothing counts."""
    n, heads, hd = 300, 8, 128
    before = LAUNCHES[k9.ATTN]
    with pytest.raises(RuntimeError, match="shared memory"):
        k9.attn_cuda(torch.zeros(1, n, 3 * heads * hd, device=card),
                     torch.zeros(3 * heads * hd, device=card),
                     torch.zeros(n, n, device=card), heads)
    assert LAUNCHES[k9.ATTN] == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_attention_reads_any_bias_table(card, shape):
    """A dense random table instead of the band: against the plain
    version; and under the band, keys outside it get no weight at all: a
    query's output is the same bit for bit whatever they hold."""
    a = _mode_inputs(card, 3, SHAPES[shape], seed=11)
    n = a["qkv"].shape[1]
    table = 2.0 * torch.randn(n, n, device=card)
    got = k9.attn_cuda(a["qkv"], a["qkv_bias"], table, a["heads"])
    assert _rel(got, ops.attn_ref(a["qkv"], a["qkv_bias"], table,
                                  a["heads"])) <= ATTN_TOL
    want = k9.attn_cuda(a["qkv"], a["qkv_bias"], a["table"], a["heads"])
    other = a["qkv"].clone()
    other[:, 3:, a["qkv"].shape[2] // 3:] = 1e4      # k and v of keys 3..
    got = k9.attn_cuda(other, a["qkv_bias"], a["table"], a["heads"])
    assert torch.equal(got[:, 0], want[:, 0])       # query 0: band 0..2


def _sample(tree, card, cfg, mode, dynamic=False, seed=0,
            dtype=torch.float32):
    g = torch.Generator(device=card).manual_seed(seed)
    t = 2 * cfg.num_frames_for_clip + 7
    r_s = torch.randn(1, cfg.dim_w, generator=g, device=card).to(dtype)
    wa = torch.randn(1, t, cfg.dim_a, generator=g, device=card).to(dtype)
    we = torch.rand(1, t if dynamic else 1, cfg.dim_e, generator=g,
                    device=card).to(dtype)
    scales = (dict(a_cfg_scale=1.0, e_cfg_scale=1.0, r_cfg_scale=1.0)
              if mode == "skip" else SCALES)
    with torch.inference_mode():
        return sampling.sample_motion_latents(
            tree, r_s, wa, we, cfg=cfg, **scales,
            generator=torch.Generator(device=card).manual_seed(seed + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_replayed_chunks_against_the_plain_eager_chunks(card, monkeypatch,
                                                        dynamic):
    """Config 1's clip of three chunks, replayed through K9, against the
    same chunks run op by op with the plain passes: ||a - b|| / ||b|| of
    the latents within 1e-5 (f32 roundings in other orders carried
    through 9 Euler steps of 8 blocks; the sampler's TF32 control reads
    ~7e-4, PERF.md)."""
    tree = _fmt(C1, 5, card)
    got = _sample(tree, card, C1, "3way", dynamic)
    monkeypatch.setattr(sampling, "chunk_graphs", lambda *a: None)
    monkeypatch.setattr(t_fmt, "block_ops", lambda *a: ops.PLAIN)
    want = _sample(tree, card, C1, "3way", dynamic)
    rel = ((got - want).norm() / want.norm()).item()
    assert 0 < rel <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["3way", "4way", "skip"])
def test_k9_launches_a_replayed_chunk(card, mode):
    """Each replay of a chunk's graph counts 9 x (1 ln_mod + 8 x (2 gated
    residuals, attention, GELU)) = 297 K9 launches, in every CFG mode."""
    cfg = C1.replace(include_r_cfg=mode == "4way")
    tree = _fmt(cfg, 6, card)
    _sample(tree, card, cfg, mode)                  # captured
    before = Counter(LAUNCHES)
    _sample(tree, card, cfg, mode)                  # three replays
    got = {k: LAUNCHES[k] - before[k] for k in k9.NAMES}
    assert got == {k9.LN_MOD: 3 * 9, k9.GATE_RES_LN_MOD: 3 * 9 * 16,
                   k9.ATTN: 3 * 9 * 8, k9.BIAS_GELU: 3 * 9 * 8}
    assert sum(got.values()) == 3 * 297


@pytest.mark.cuda
def test_a_bf16_sampler_replays_through_k9(card):
    """Config 1's sampler in bf16 (``sampler_dtype``'s other setting)
    takes K9: 297 launches a replayed chunk, and its latents within
    tests/test_serving.py's bf16 integration floor of the f32 sampler's
    (max|diff| < 0.1 max|f32|)."""
    tree = _fmt(C1, 8, card)
    want = _sample(tree, card, C1, "3way")
    _sample(tree, card, C1, "3way", dtype=torch.bfloat16)     # captured
    before = Counter(LAUNCHES)
    got = _sample(tree, card, C1, "3way", dtype=torch.bfloat16)
    counts = {k: LAUNCHES[k] - before[k] for k in k9.NAMES}
    assert sum(counts.values()) == 3 * 297
    assert got.dtype == torch.bfloat16
    err = _rel(got.float(), want)
    assert err < 0.1, err
