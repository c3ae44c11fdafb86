"""float_torch.parallel and the mesh mode against float_tpu.parallel, on
the CPU: the port's mesh names 8 CPU ranks (one process, one device
named eight times), float_tpu's the 8 virtual CPU devices of
tests/conftest.py; arrays pass between them as numpy.

Tolerances are float_tpu's own tests/test_parallel.py's: the tensor-
parallel FMT within rtol 2e-4 / atol 2e-5 (each row-parallel layer sums
its ranks' partials in another order than one matmul), wav2vec2, the
frame-parallel synthesis and the mesh pipeline's frames within 2e-4;
generate_batch's clips within one uint8 level (1/255 + 2e-4, the wire).
The device guard of the launchers is tested in test_torch_devices.py,
which runs on the card too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from float_tpu.models import fmt as j_fmt
from float_tpu.models import init as j_init
from float_tpu.models import synthesis as j_synthesis
from float_tpu.models import wav2vec2 as j_w2v
from float_tpu.parallel.mesh import make_mesh as j_make_mesh
from float_tpu.runtime import pipeline as jp
from float_torch import config as t_config
from float_torch.models import fmt as t_fmt
from float_torch.models import init as t_init
from float_torch.models import wav2vec2 as t_w2v
from float_torch.parallel import (Mesh, batch_split, gather, make_mesh,
                                  parse_mesh_spec, replicate, shard_fmt,
                                  shard_wav2vec2)
from float_torch.runtime import pipeline as tp
from float_torch.runtime.decode import FrameParallel, decode_chunk
from test_torch_nodes import patch_samplers
from torch_parity import TINY, TINY_SER, TINY_W2V, max_err, port_params, randn

CPU8 = [torch.device("cpu")] * 8
PT_TINY = t_config.FloatConfig(**dataclasses.asdict(TINY))
PT_W2V = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_W2V))
PT_SER = t_config.Wav2Vec2Config(**dataclasses.asdict(TINY_SER))


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_factorises_as_float_tpu(n):
    mesh = make_mesh(n, devices=CPU8)
    want = j_make_mesh(n).devices.shape
    assert (mesh.shape["data"], mesh.shape["model"]) == want
    assert mesh.size == n and len(mesh.flat) == n


def test_make_mesh_shapes():
    """tests/test_parallel.py's cases."""
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    assert make_mesh(8, data=8, devices=CPU8).shape == {"data": 8,
                                                        "model": 1}
    assert make_mesh(8, model=2, devices=CPU8).shape == {"data": 4,
                                                         "model": 2}
    with pytest.raises(ValueError):
        make_mesh(8, data=3, model=3, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(data=2, model=4, devices=CPU8[:4])


def test_make_mesh_takes_cuda_devices_only_when_given_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    assert make_mesh(devices=CPU8[:2]).flat == CPU8[:2]


def test_parse_mesh_spec():
    assert parse_mesh_spec("data=2,model=4") == {"data": 2, "model": 4}
    assert parse_mesh_spec("model=2") == {"model": 2}
    for bad in ("data=x", "rows=2", "data"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad)


def test_replicate_split_gather():
    mesh = Mesh([CPU8[:2], CPU8[2:4]])
    x = torch.arange(12.0).reshape(4, 3)
    copies = replicate(x, mesh.flat)
    assert len(copies) == 4 and all(torch.equal(c, x) for c in copies)
    pieces = batch_split(mesh, x)
    assert [p.shape[0] for p in pieces] == [2, 2]
    assert torch.equal(gather(pieces, mesh.primary), x)
    nested = gather([(p, [p * 2]) for p in pieces], mesh.primary)
    assert torch.equal(nested[1][0], x * 2)
    with pytest.raises(ValueError, match="divide"):
        batch_split(mesh, x[:3])


# ---------------------------------------------------------------------------
# tensor-parallel towers
# ---------------------------------------------------------------------------

def _fmt_args(rng, b=2):
    clip, prev = TINY.num_frames_for_clip, TINY.num_prev_frames
    return (randn(rng, 1), randn(rng, b, clip, TINY.dim_w),
            randn(rng, b, clip, TINY.dim_a), randn(rng, b, TINY.dim_w),
            randn(rng, b, 1, TINY.dim_e), randn(rng, b, prev, TINY.dim_w),
            randn(rng, b, prev, TINY.dim_a))


FMT_KW = dict(depth=TINY.fmt_depth, num_heads=TINY.num_heads,
              attention_window=TINY.attention_window)


@pytest.fixture(scope="module")
def fmt_case():
    params = j_init.init_fmt(TINY, seed=5)
    args = _fmt_args(np.random.default_rng(0))
    want = j_fmt.fmt_forward(params, *map(jnp.asarray, args), None, **FMT_KW)
    return params, args, np.asarray(want)


def _port_fmt(params, args, ranks):
    mod = port_params(params)
    n = shard_fmt(mod, CPU8[:ranks], TINY.num_heads)
    with torch.inference_mode():
        out = t_fmt.fmt_forward(mod, *map(torch.from_numpy, args), None,
                                **FMT_KW)
    return mod, n, out


@pytest.mark.parametrize("ranks", [2, 4, 3])
def test_fmt_tp_matches_float_tpu(fmt_case, ranks):
    """The FMT split over a row of 2 or 4 ranks (heads and MLP width
    divide) equals float_tpu's fmt_forward; over 3 every layer stays
    whole (4 heads and 256 hidden do not divide by 3)."""
    params, args, want = fmt_case
    mod, n, got = _port_fmt(params, args, ranks)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    attn = mod["blocks"]["0"]["attn"]
    if ranks == 3:
        assert n == 0 and attn.tp_shards is None
        return
    assert n == 2 * TINY.fmt_depth and len(attn.tp_shards) == ranks
    h = TINY.dim_h
    assert attn.tp_shards[0]["qkv"]["weight"].shape == (3 * h // ranks, h)
    assert attn.tp_shards[0]["proj"]["weight"].shape == (h, h // ranks)
    # rank 1 holds head group 1 of each of q, k and v
    q, k, _v = params["blocks"]["0"]["attn"]["qkv"]["weight"].reshape(
        3, h, h)
    got_q = attn.tp_shards[1]["qkv"]["weight"][:h // ranks].numpy()
    np.testing.assert_array_equal(got_q, q[h // ranks:2 * h // ranks])
    got_k = attn.tp_shards[1]["qkv"]["weight"][h // ranks:2 * h // ranks]
    np.testing.assert_array_equal(got_k.numpy(),
                                  k[h // ranks:2 * h // ranks])


def test_fmt_contiguous_qkv_split_fails(fmt_case):
    """Control: rank r of 4 taking a contiguous quarter of qkv's stacked
    q, k, v rows (rank 0 three quarters of q, rank 1 the rest of q and
    half of k, ...) is not the FMT."""
    params, args, want = fmt_case
    mod = port_params(params)
    shard_fmt(mod, CPU8[:4], TINY.num_heads)
    for blk in mod["blocks"].children():
        attn = blk["attn"]
        for r, s in enumerate(attn.tp_shards):
            s["qkv"] = {k: attn["qkv"][k].detach().chunk(4, 0)[r]
                        for k in ("weight", "bias")}
    with torch.inference_mode():
        got = t_fmt.fmt_forward(mod, *map(torch.from_numpy, args), None,
                                **FMT_KW)
    assert not np.allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    assert max_err(got, want) > 1e-2


@pytest.fixture(scope="module")
def wav2vec2_case():
    rng = np.random.default_rng(1)
    wave = randn(rng, 2, 3200, scale=0.1)
    mask = np.ones((2, 3200), np.float32)
    mask[1, 2400:] = 0
    base = j_init.init_wav2vec2(TINY_W2V, seed=6)
    ser = j_init.init_wav2vec2(TINY_SER, seed=7)
    want_h = jax.jit(lambda p, w: j_w2v.wav2vec2_frame_features(
        p, w, 20, TINY_W2V).last_hidden_state)(base, jnp.asarray(wave))
    want_s = jax.jit(lambda p, w, m: j_w2v.ser_logits(
        p, w, TINY_SER, attention_mask=m))(ser, jnp.asarray(wave),
                                           jnp.asarray(mask))
    return base, ser, wave, mask, np.asarray(want_h), np.asarray(want_s)


@pytest.mark.parametrize("ranks", [2, 4])
def test_wav2vec2_tp_matches_float_tpu(wav2vec2_case, ranks):
    """Both towers split over a row: the base tower's frame features
    (post-LN blocks) and the SER's logits with an attention mask (pre-LN
    blocks, the additive key bias on every rank)."""
    base, ser, wave, mask, want_h, want_s = wav2vec2_case
    tb, ts = port_params(base), port_params(ser)
    for mod, cfg in ((tb, TINY_W2V), (ts, TINY_SER)):
        n = shard_wav2vec2(mod, CPU8[:ranks], cfg.num_attention_heads)
        assert n == 2 * cfg.num_hidden_layers
    with torch.inference_mode():
        got_h = t_w2v.wav2vec2_frame_features(
            tb, torch.from_numpy(wave), 20, PT_W2V).last_hidden_state
        got_s = t_w2v.ser_logits(ts, torch.from_numpy(wave), PT_SER,
                                 attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# frame-parallel decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthesis_case():
    """tests/test_parallel.py's frame-parallel case: 32², 8 frames."""
    rng = np.random.default_rng(2)
    dec = j_init.init_synthesis(32, 32, 20, seed=8)
    wa = randn(rng, 8, 32, scale=0.5)
    feats = [randn(rng, 1, c, s, s) for c, s in ((512, 8), (512, 16),
                                                 (512, 32))]
    img, _ = jax.jit(lambda p, w, f: j_synthesis.synthesis_cl(
        p, w, f, 32, use_warp_kernel=False))(
        dec, jnp.asarray(wa),
        [jnp.transpose(jnp.asarray(f), (0, 2, 3, 1)) for f in feats])
    want = (np.clip(np.asarray(img), -1.0, 1.0) + 1.0) * 0.5
    if want.shape[-1] != 3:
        want = want.transpose(0, 2, 3, 1)
    return port_params(dec), wa, feats, want


@pytest.mark.parametrize("ranks", [8, 3])
def test_frame_parallel_synthesis_matches(synthesis_case, ranks):
    """8 frames over 8 ranks (one frame each: per-frame warps) or 3
    (3, 3, 2: shared-map warps) equal float_tpu's synthesis, and the
    port's own single decode_chunk within 1e-5 (a CPU convolution sums a
    batch of 1 and of 8 in other orders, ~3e-6 here)."""
    params, wa, feats, want = synthesis_case
    wa_t = torch.from_numpy(wa)
    feats_t = [torch.from_numpy(f) for f in feats]
    with torch.inference_mode():
        got = FrameParallel(CPU8[:ranks])(params, wa_t, feats_t, 32)
        one = decode_chunk(params, wa_t, feats_t, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return jp.build_synthetic_pipeline(TINY, TINY_W2V, TINY_SER).params


@pytest.fixture(scope="module")
def port_mesh_pipe(jax_params):
    return tp.FloatPipeline(jax.tree.map(np.asarray, jax_params),
                            PT_TINY.replace(decode_batch=8), PT_W2V, PT_SER,
                            mesh=make_mesh(8, devices=CPU8))


def test_mesh_pipeline_generate_matches_float_tpu(jax_params,
                                                  port_mesh_pipe):
    """FloatPipeline(mesh=) against float_tpu's FloatPipeline(mesh=
    make_mesh(8)) at TINY, decode_batch 8, both samplers fed the same
    numpy noise."""
    jmesh = j_make_mesh(8)
    jpipe = jp.FloatPipeline(jax_params, TINY.replace(decode_batch=8),
                             TINY_W2V, TINY_SER, mesh=jmesh)
    rng = np.random.default_rng(3)
    img = randn(rng, 1, 3, TINY.input_size, TINY.input_size, scale=0.3)
    wave = randn(rng, 1, 8000, scale=0.1)
    with pytest.MonkeyPatch.context() as mp:
        patch_samplers(mp)
        with jmesh:
            want = np.asarray(jpipe.generate(jnp.asarray(img),
                                             jnp.asarray(wave),
                                             emotion="happy", seed=11))
        got = port_mesh_pipe.generate(img, wave, emotion="happy", seed=11)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    attn = port_mesh_pipe.params["fmt"]["blocks"]["0"]["attn"]
    assert len(attn.tp_shards) == 4          # the model axis of 2x4


def test_mesh_ragged_generate_batch_matches_serial():
    """A ragged batch over a 2x4 mesh (4 images split over the data axis;
    two length groups of 2, each split) equals serial single-device
    generate calls (32 channels at every image level, for time)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_init, "CHANNELS_MAP",
                   dict.fromkeys(t_init.CHANNELS_MAP, 32))
        one = tp.build_synthetic_pipeline(PT_TINY, PT_W2V, PT_SER,
                                          device="cpu")
        mesh_pipe = tp.FloatPipeline(one.params,
                                     PT_TINY.replace(decode_batch=8), PT_W2V,
                                     PT_SER, mesh=make_mesh(8, devices=CPU8))
    rng = np.random.default_rng(4)
    imgs = randn(rng, 4, 3, TINY.input_size, TINY.input_size, scale=0.3)
    lens = (4000, 8000, 4000, 8000)
    waves = [randn(rng, n, scale=0.1) for n in lens]
    seeds = [31, 32, 33, 34]
    outs = mesh_pipe.generate_batch(imgs, waves, emotion="none", seeds=seeds)
    for i, seed in enumerate(seeds):
        assert outs[i].shape[0] == tp.audio_num_frames(lens[i], PT_TINY)
        ref = one.generate(imgs[i:i + 1], waves[i][None], emotion="none",
                           seed=seed).numpy()
        np.testing.assert_allclose(outs[i], ref, atol=1 / 255.0 + 2e-4)


def test_mesh_refuses_undivided_decode_batch(jax_params):
    with pytest.raises(ValueError, match="divisible"):
        tp.FloatPipeline(jax.tree.map(np.asarray, jax_params), PT_TINY,
                         PT_W2V, PT_SER, mesh=make_mesh(8, devices=CPU8))
