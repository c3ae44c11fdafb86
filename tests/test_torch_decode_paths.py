"""The decode paths of the port against float_tpu's, on CPU:

- synthesis of a one-frame chunk (every level warps per frame: K3's path)
  and the last level with the ToRGB in the warp (K2's path), against
  synthesis_cl with the real TPU kernels in Pallas interpret mode;
- the chunk program's uint8 and 4:2:0 wires, the 4:2:0 codec, and the
  host-delivery loops (to host, stream, several clips) against their JAX
  twins at 64², where the JAX decode takes the exact gather warp."""
import functools
import inspect
import time

import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import float_tpu.ops.pallas.shift_warp_kernel as j_k3
import float_tpu.ops.pallas.shift_warp_v2 as j_v2
from float_tpu.models import init as j_init
from float_tpu.models import synthesis as j_syn
from float_tpu.ops import yuv420 as j_yuv
from float_tpu.runtime import decode as j_dec
from float_torch.models import synthesis as t_syn
from float_torch.ops import yuv420 as t_yuv
from float_torch.runtime import decode as t_dec
from float_torch.utils import profiling
from torch_parity import max_err, port_params, randn

BF16_FLOOR = 6.3e-2      # tests/test_warp_v2_interpret.py's bf16 bound
SMALL = {4: 32, 8: 32, 16: 32, 32: 32, 64: 32, 128: 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny shapes gain nothing from torch's thread pool, whose
    threads, one per core by default, spin between ops: under the suite's
    parallel workers they oversubscribe the CPU and slow every file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(f):
    return jnp.transpose(jnp.asarray(f), (0, 2, 3, 1))


@pytest.fixture(scope="module")
def small_synthesis():
    """A 128² synthesis with 32 channels at every level (the channel map
    of tests/test_warp_v2_interpret.py), flows shrunk to stay within the
    TPU kernels' D=2, its weights in bf16 on both sides, and seeded
    inputs: 5 skip maps of batch 1 and 8 latents."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_init, "CHANNELS_MAP", SMALL)
    try:
        dec = j_init.init_synthesis(128, 32, 20, seed=2)
    finally:
        mp.undo()
    for lvl in dec["to_flows"]:
        conv = dec["to_flows"][lvl]["conv"]
        conv["weight"] = conv["weight"] * 0.05
    rng = np.random.default_rng(9)
    feats = [randn(rng, 1, SMALL[r], r, r, scale=0.5)
             for r in (8, 16, 32, 64, 128)]
    wa = randn(rng, 8, 32, scale=0.3)
    return dec, feats, wa


def _port_bf16(dec, feats, wa, b, **kw):
    params = port_params(dec).to(torch.bfloat16)
    with torch.inference_mode():
        img, _ = t_syn.synthesis(
            params, torch.from_numpy(wa[:b]).to(torch.bfloat16),
            [torch.from_numpy(f) for f in feats], 128, **kw)
    return img.permute(0, 2, 3, 1)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (made while JAX traces)."""
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_one_frame_chunk_matches_k3_synthesis(small_synthesis, monkeypatch):
    """One frame, skip maps of batch 1: every level takes the per-frame
    warp; in float_tpu the 128² level runs K3 (warp_cl's per-frame
    branch) in interpret mode."""
    calls = _spy(monkeypatch, j_k3, "_shift_warp_nhwc")
    dec, feats, wa = small_synthesis
    dec16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), dec)
    # jitted as one program (see test_torch_warp_variants)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jax.block_until_ready(jax.jit(functools.partial(
            j_syn.synthesis_cl, size=128, use_warp_kernel=True))(
            dec16, jnp.asarray(wa[:1]).astype(jnp.bfloat16),
            [_nhwc(f).astype(jnp.bfloat16) for f in feats]))
    assert calls, "float_tpu did not take K3"
    got = _port_bf16(dec, feats, wa, 1)
    assert got.shape == (1, 128, 128, 3)
    assert max_err(got, want) < BF16_FLOOR


def test_rgb_in_kernel_matches_k2_synthesis(small_synthesis, monkeypatch):
    """8 frames sharing their skip maps, the last level's ToRGB contracted
    in the warp: float_tpu's packed last level with RGB_IN_KERNEL runs K2
    in interpret mode (optimistic program, flows within D)."""
    calls = _spy(monkeypatch, j_v2, "warp_shared_feat_v2_packed_rgb")
    dec, feats, wa = small_synthesis
    dec16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), dec)
    monkeypatch.setattr(j_syn, "RGB_IN_KERNEL", True)
    with pltpu.force_tpu_interpret_mode():
        want, _, _, flags = jax.block_until_ready(jax.jit(functools.partial(
            j_syn.synthesis_cl, size=128, collect_flow_stats=True,
            apply_fixup=False))(
            dec16, jnp.asarray(wa).astype(jnp.bfloat16),
            [_nhwc(f).astype(jnp.bfloat16) for f in feats]))
    assert calls, "float_tpu did not take K2"
    assert int(np.asarray(flags).reshape(-1, 2)[0, 0]) == 0, "flow beyond D"
    got = _port_bf16(dec, feats, wa, 8, rgb_in_kernel=True)
    assert got.shape == (8, 128, 128, 3)
    assert max_err(got, want) < BF16_FLOOR


@pytest.mark.parametrize("b", [1, 4])
def test_rgb_in_kernel_equals_warp_then_conv_f32(small_synthesis, b):
    """In f32 the fused last level is the unfused one up to summation
    order; with one frame (a per-frame last level) it is not taken."""
    dec, feats, wa = small_synthesis
    params = port_params(dec)
    args = (params, torch.from_numpy(wa[:b]),
            [torch.from_numpy(f) for f in feats], 128)
    with torch.inference_mode():
        fused, f64 = t_syn.synthesis(*args, rgb_in_kernel=True)
        plain, p64 = t_syn.synthesis(*args, rgb_in_kernel=False)
    assert max_err(fused, plain) <= 1e-5
    assert torch.equal(f64, p64)


# --- 64²: the chunk program's wires and the host loops ---------------------

@pytest.fixture(scope="module")
def tiny_decode():
    """init_synthesis(64) with 32 channels at every level (4 levels),
    batch-1 skip maps, s_r and 13 motion latents."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_init, "CHANNELS_MAP", SMALL)
    try:
        dec = j_init.init_synthesis(64, 64, 20, seed=1)
    finally:
        mp.undo()
    rng = np.random.default_rng(3)
    feats = [randn(rng, 1, SMALL[r], r, r, scale=0.5) for r in (8, 16, 32, 64)]
    s_r = randn(rng, 1, 64, scale=0.3)
    r_d = randn(rng, 13, 64, scale=0.3)
    return dec, port_params(dec), feats, s_r, r_d


@pytest.mark.parametrize("wire", [True, "yuv420"])
def test_decode_chunk_wires_match_float_tpu(tiny_decode, wire):
    dec, params, feats, s_r, r_d = tiny_decode
    wa = s_r + r_d[:4]
    want = j_dec._chunk_core(dec, jnp.asarray(wa), [_nhwc(f) for f in feats],
                             64, out_u8=wire, use_warp_kernel=False)
    with torch.inference_mode():
        got = t_dec.decode_chunk(params, torch.from_numpy(wa),
                                 [torch.from_numpy(f) for f in feats], 64,
                                 out_u8=wire)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1


def test_yuv420_codec_matches_float_tpu():
    rng = np.random.default_rng(2)
    img = rng.random((3, 16, 24, 3)).astype(np.float32)
    img[0, :4] = 0.0
    img[1, :4] = 1.0
    want = np.asarray(j_yuv.rgb01_to_i420(jnp.asarray(img)))
    got = t_yuv.rgb01_to_i420(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3, 24, 24)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(t_yuv.i420_to_rgb_u8(want),
                                  j_yuv.i420_to_rgb_u8(want))
    np.testing.assert_array_equal(t_yuv.i420_to_rgb_u8(want[0]),
                                  j_yuv.i420_to_rgb_u8(want[0]))


HOST_TOL = 1 / 255 + 1e-4      # one uint8 step of the wire


def _args(tiny_decode):
    dec, params, feats, s_r, r_d = tiny_decode
    return (dict(params=dec, s_r=jnp.asarray(s_r),
                 feats=[jnp.asarray(f) for f in feats], r_d=jnp.asarray(r_d)),
            dict(params=params, s_r=torch.from_numpy(s_r),
                 feats=[torch.from_numpy(f) for f in feats],
                 r_d=torch.from_numpy(r_d)))


@pytest.mark.parametrize("u8", [True, False])
def test_decode_latents_to_host_matches_float_tpu(tiny_decode, u8):
    j, t = _args(tiny_decode)
    want = j_dec.decode_latents_to_host(
        j["params"], j["s_r"], j["feats"], j["r_d"], size=64, decode_batch=8,
        uint8_transfer=u8, use_warp_kernel=False)
    events = []
    got = t_dec.decode_latents_to_host(
        t["params"], t["s_r"], t["feats"], t["r_d"], size=64, decode_batch=8,
        uint8_transfer=u8, frame_callback=lambda i, n: events.append((i, n)))
    assert got.dtype == np.float32 and got.shape == want.shape == (13, 64, 64, 3)
    assert np.abs(got - want).max() <= (HOST_TOL if u8 else 1e-4)
    assert events == [(0, 2), (1, 2)]


def _pieces(r_d, k=5):
    return [r_d[i:i + k] for i in range(0, r_d.shape[0], k)]


@pytest.mark.parametrize("emit", ["f32", "u8", "yuv420"])
def test_decode_latents_stream_matches_float_tpu(tiny_decode, emit):
    """first_chunk=4, then chunks of 8, 13 frames: a padded partial last
    chunk; latents arrive in pieces of 5."""
    j, t = _args(tiny_decode)
    kw = dict(size=64, decode_batch=8, first_chunk=4, emit=emit)
    want = list(j_dec.decode_latents_stream(
        j["params"], j["s_r"], j["feats"], iter(_pieces(j["r_d"])),
        use_warp_kernel=False, **kw))
    got = list(t_dec.decode_latents_stream(
        t["params"], t["s_r"], t["feats"], iter(_pieces(t["r_d"])), **kw))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 4, 12]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if emit == "f32":
            assert np.abs(g - w).max() <= HOST_TOL
        else:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_decode_clips_to_host_matches_float_tpu(tiny_decode):
    j, t = _args(tiny_decode)
    j_clips = [(j["s_r"], j["feats"], j["r_d"]),
               (j["s_r"] * 0.5, j["feats"], j["r_d"][:6])]
    t_clips = [(t["s_r"], t["feats"], t["r_d"]),
               (t["s_r"] * 0.5, t["feats"], t["r_d"][:6])]
    want = j_dec.decode_clips_to_host(j["params"], j_clips, size=64,
                                      decode_batch=8, use_warp_kernel=False)
    events = []
    got = t_dec.decode_clips_to_host(
        t["params"], t_clips, size=64, decode_batch=8,
        frame_callback=lambda i, n: events.append((i, n)))
    assert [g.shape[0] for g in got] == [13, 6]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= HOST_TOL
    assert events == [(0, 3), (1, 3), (2, 3)]


def test_one_frame_chunks_equal_batched_decode(tiny_decode):
    """decode_batch=1 (every level per frame) gives the batched decode's
    frames in f32."""
    _, params, feats, s_r, r_d = tiny_decode
    args = (params, torch.from_numpy(s_r),
            [torch.from_numpy(f) for f in feats], torch.from_numpy(r_d[:5]))
    with torch.inference_mode():
        one = t_dec.decode_latents(*args, size=64, decode_batch=1)
        batched = t_dec.decode_latents(*args, size=64, decode_batch=8)
    assert one.shape == (5, 64, 64, 3)
    assert max_err(one, batched) <= 1e-5


# --- every entry point's chunk plan, spans and callbacks -------------------

def _stream(params, s_r, feats, r_d, cb, **kw):
    return list(t_dec.decode_latents_stream(
        params, s_r, feats, iter(_pieces(r_d)), size=64, decode_batch=8,
        frame_callback=cb, **kw))


# entry point -> (its call on the 13 latents at fb 8; per chunk its rows,
# out_u8, rgb_in_kernel and blur_kernel, its decode.chunk's index, and
# the callback's (i, n)).  Clips: full chunks, the last shrunk to the
# smallest multiple of 4 covering the rest (13 -> 8 + 8, 10 -> 8 + 4);
# the stream: the ramp's first_chunk_size, then 8s, the last padded.
B = (1, 3, 3, 1)
PLANS = {
    "decode_latents": (
        lambda p, s, f, r, cb: t_dec.decode_latents(
            p, s, f, r, size=64, decode_batch=8, rgb_in_kernel=True,
            frame_callback=cb),
        [(8, False, True, B, 0, (0, 2)), (8, False, True, B, 1, (1, 2))]),
    "decode_latents_to_host": (
        lambda p, s, f, r, cb: t_dec.decode_latents_to_host(
            p, s, f, r, size=64, decode_batch=8, frame_callback=cb),
        [(8, True, False, B, 0, (0, 2)), (8, True, False, B, 1, (1, 2))]),
    "decode_latents_stream first_chunk=0": (
        _stream,
        [(8, True, False, B, 0, (0, -1)), (8, True, False, B, 1, (1, -1))]),
    "decode_latents_stream first_chunk=4": (
        lambda p, s, f, r, cb: _stream(p, s, f, r, cb, first_chunk=4,
                                       emit="u8"),
        [(4, True, False, B, 0, (0, -1)), (8, True, False, B, 1, (1, -1)),
         (8, True, False, B, 2, (2, -1))]),
    "decode_clips_to_host": (
        lambda p, s, f, r, cb: t_dec.decode_clips_to_host(
            p, [(s, f, r), (s * 0.5, f, r[:10])], size=64, decode_batch=8,
            uint8_transfer=False, frame_callback=cb),
        [(8, False, False, B, 0, (0, 4)), (8, False, False, B, 1, (1, 4)),
         (8, False, False, B, 0, (2, 4)), (4, False, False, B, 1, (3, 4))]),
}


@pytest.mark.parametrize("entry", sorted(PLANS))
def test_each_entry_points_chunk_plan_spans_and_callbacks(tiny_decode,
                                                          monkeypatch, entry):
    """Every ``decode_chunk`` call of an entry point (its rows and the
    values it takes for out_u8, rgb_in_kernel and blur_kernel, an absent
    keyword counted as its default), one ``decode.chunk`` span around
    each with the chunk's ``frames`` and ``index`` (from 0 again for each
    clip), and the callback's events.  ``decode_latents`` reports chunk c
    between its span's end and chunk c+1's start; the host paths keep
    one chunk in flight: chunk c+1's span opens before chunk c's
    callback."""
    run, plan = PLANS[entry]
    _, params, feats, s_r, r_d = tiny_decode
    real = t_dec.decode_chunk
    sig = inspect.signature(real)
    calls, events = [], []

    def recorded(*a, **k):
        args = sig.bind(*a, **k)
        args.apply_defaults()
        kw = args.arguments
        calls.append((kw["wa_chunk"].shape[0], kw["out_u8"],
                      kw["rgb_in_kernel"], tuple(kw["blur_kernel"])))
        return real(*a, **k)
    monkeypatch.setattr(t_dec, "decode_chunk", recorded)
    profiling.tracing_on()
    try:
        with torch.inference_mode():
            run(params, torch.from_numpy(s_r),
                [torch.from_numpy(f) for f in feats], torch.from_numpy(r_d),
                lambda i, n: events.append((i, n, time.time_ns())))
        spans = sorted((s for s in profiling.take().spans
                        if s.name == "decode.chunk"), key=lambda s: s.start_ns)
    finally:
        profiling.tracing_off()
    assert calls == [p[:4] for p in plan]
    assert [(s.attrs["index"], s.attrs["frames"]) for s in spans] == [
        (p[4], p[0]) for p in plan]
    assert [e[:2] for e in events] == [p[5] for p in plan]
    for c, (_i, _n, at) in enumerate(events[:-1]):
        if entry == "decode_latents":            # on dispatch
            assert spans[c].end_ns <= at <= spans[c + 1].start_ns
        else:                                    # on arrival
            assert spans[c + 1].start_ns < at
