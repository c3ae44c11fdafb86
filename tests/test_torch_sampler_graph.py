"""The sampler's chunk graphs (``float_torch.runtime.sampling``): which
inputs key a graph, where the chunks run eagerly, the cache's bound, the
FMT's tables made once a device, and the graph path's bookkeeping on the
CPU with a stand-in for the CUDA graph.  The ``cuda`` tests hold replayed
chunks to eager ones at config 1's widths on the card.  Imports neither
JAX nor float_tpu, so the card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_torch_sampler_graph.py``.
"""
import gc

import numpy as np
import pytest
import torch

from float_torch.config import FloatConfig, Wav2Vec2Config
from float_torch.models import fmt as fmt_mod
from float_torch.models.init import ParamTree, init_fmt
from float_torch.parallel.sharding import shard_fmt
from float_torch.runtime import sampling
from float_torch.runtime.pipeline import build_synthetic_pipeline
from float_torch.utils import profiling

W2V = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
           conv_stride=(5, 2, 2), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
CFG = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                  dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                  num_prev_frames=3, decode_batch=4, compute_dtype="float32")
SCALES = dict(a_cfg_scale=2.0, e_cfg_scale=1.0, r_cfg_scale=1.0)


@pytest.fixture(scope="module")
def pipe():
    w2v = Wav2Vec2Config(feat_extract_norm="group", conv_bias=False,
                         do_stable_layer_norm=False, **W2V)
    ser = Wav2Vec2Config(feat_extract_norm="layer", conv_bias=True,
                         do_stable_layer_norm=True, num_labels=7, **W2V)
    return build_synthetic_pipeline(CFG, w2v, ser, device="cpu")


def _conditions(cfg, t, b=1, dynamic=False, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    r_s = torch.randn(b, cfg.dim_w, generator=g)
    wa = torch.randn(b, t, cfg.dim_a, generator=g)
    we = torch.rand(b, t if dynamic else 1, cfg.dim_e, generator=g)
    return r_s.to(device), wa.to(device), we.to(device)


def _key(cfg=CFG, b=1, t=None, dtype=torch.float32, dynamic=False,
         chunk=0, **kw):
    """graph_key of chunk ``chunk`` of a clip of ``t`` frames, its CFG
    mode inferred from the scales as the sampler infers it."""
    clip, prev = cfg.num_frames_for_clip, cfg.num_prev_frames
    t = 3 * clip if t is None else t
    r_s, wa, we = (x.to(dtype) for x in _conditions(cfg, t, b, dynamic))
    wa = sampling.pad_to_chunks(wa, clip)
    sl = slice(chunk * clip, (chunk + 1) * clip)
    carry = sampling.sampler_init_carry(b, cfg, dtype)
    x0 = torch.zeros(b, clip, cfg.dim_w, dtype=dtype)
    args = dict(cfg=cfg, nfe=cfg.nfe, ode_method="euler", cfg_mode=None,
                **SCALES)
    args.update(kw)
    scales = [args.pop(k) for k in ("a_cfg_scale", "r_cfg_scale",
                                    "e_cfg_scale")]
    args["cfg_mode"] = args["cfg_mode"] or fmt_mod.infer_cfg_mode(
        *scales, cfg.include_r_cfg)
    return sampling.graph_key(r_s, wa[:, sl], we[:, sl] if dynamic else we,
                              carry, x0, **args)


KEYED = {"batch": dict(b=2), "dtype": dict(dtype=torch.bfloat16),
         "nfe": dict(nfe=5), "ode_method": dict(ode_method="midpoint"),
         "cfg_mode": dict(cfg_mode="skip"),
         "scales_all_one": dict(a_cfg_scale=1.0),
         "four_way": dict(cfg=CFG.replace(include_r_cfg=True)),
         "dynamic_we": dict(dynamic=True),
         "chunk_length": dict(cfg=CFG.replace(wav2vec_sec=0.8)),
         "prev_frames": dict(cfg=CFG.replace(num_prev_frames=2))}


@pytest.mark.parametrize("change", sorted(KEYED))
def test_each_keyed_input_changes_the_key(change):
    assert _key(**KEYED[change]) != _key()


@pytest.mark.parametrize("t, chunk", [(25, 0), (25, 2), (70, 6), (10, 0)])
def test_the_clips_length_and_the_chunks_index_do_not(t, chunk):
    assert _key(t=t, chunk=chunk) == _key()


@pytest.mark.parametrize("scales", [dict(a_cfg_scale=2.5),
                                    dict(e_cfg_scale=1.5),
                                    dict(r_cfg_scale=1.5),
                                    dict(a_cfg_scale=1.3, e_cfg_scale=0.7)])
def test_nor_do_the_cfg_scales_within_a_mode(scales):
    """The scales are inputs of the graph: a request's own scales take
    the graph its mode has."""
    assert _key(**scales) == _key()


def _chunk_spans(run):
    profiling.tracing_on()
    try:
        out = run()
        spans = [s for s in profiling.take().spans
                 if s.name == "sample.chunk"]
    finally:
        profiling.tracing_off()
    return out, spans


def _captures(monkeypatch) -> list:
    """The CFG scales of each chunk graph made from here on:
    ``sampling._ChunkGraph`` (or its stand-in) wrapped in a recording
    constructor."""
    made, real = [], sampling._ChunkGraph

    def make(fmt_params, inputs, scales, kw):
        made.append(scales)
        return real(fmt_params, inputs, scales, kw)
    monkeypatch.setattr(sampling, "_ChunkGraph", make)
    return made


def _plain(tree):
    """A nested dict of tensors (no ParamTree)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _tp_fmt(cfg):
    fmt = ParamTree(init_fmt(cfg))
    assert shard_fmt(fmt, [torch.device("cpu")] * 2, cfg.num_heads)
    return fmt


@pytest.mark.parametrize("params", ["cpu pipeline", "tp_shards",
                                    "plain dict"])
def test_where_no_graph_applies_the_chunks_run_eagerly(pipe, monkeypatch,
                                                      params):
    """A CPU pipeline, an FMT split over model ranks and a plain dict of
    weights run every chunk eagerly (graphed = 0, so none replayed), and
    none of them makes a graph; the last two would not on a card either."""
    fmt = {"cpu pipeline": lambda: pipe.params["fmt"],
           "tp_shards": lambda: _tp_fmt(CFG),
           "plain dict": lambda: _plain(init_fmt(CFG))}[params]()
    if params != "cpu pipeline":
        assert sampling.chunk_graphs(fmt, torch.device("cuda")) is None
    r_s, wa, we = _conditions(CFG, 25)
    made = _captures(monkeypatch)
    _r_d, spans = _chunk_spans(lambda: sampling.sample_motion_latents(
        fmt, r_s, wa, we, cfg=CFG, generator=torch.Generator().manual_seed(1)))
    assert [s.attrs["graphed"] for s in spans] == [0, 0, 0]
    assert made == []
    assert getattr(fmt, "chunk_graphs", None) is None


def test_the_cache_drops_its_least_recently_used_key():
    graphs = sampling.ChunkGraphs(size=2)
    made = []

    def make(name):
        return lambda: made.append(name) or name
    assert graphs.get("a", make("a")) == "a"
    assert graphs.get("b", make("b")) == "b"
    assert graphs.get("a", make("a2")) == "a"      # kept, now the newest
    assert graphs.get("c", make("c")) == "c"       # drops b
    assert list(graphs.graphs) == ["a", "c"]
    assert graphs.get("b", make("b2")) == "b2"     # made again, drops a
    assert list(graphs.graphs) == ["c", "b"]
    assert made == ["a", "b", "c", "b2"]


def _old_pos_embed(n_position, d_hid, device=None):
    pos = np.arange(n_position)[:, None]
    idx = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (idx // 2) / d_hid)
    table = angle.copy()
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table.astype(np.float32)).to(device)


def _old_bias(t, s, expansion, device=None):
    blocked = np.ones((t, s), dtype=bool)
    for i in range(t):
        blocked[i, max(0, i - expansion): i + expansion + 1] = False
    return torch.from_numpy(
        np.where(blocked, -1e9, 0.0).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape", [(13, 64, 2), (60, 1024, 2)])
def test_the_tables_are_made_once_and_equal_the_per_call_ones(shape):
    n, d, window = shape
    cpu = torch.device("cpu")
    pos = fmt_mod.sinusoid_pos_embed(n, d, cpu)
    bias = fmt_mod.alignment_bias(n, n, window, cpu)
    assert torch.equal(pos, _old_pos_embed(n, d))
    assert torch.equal(bias, _old_bias(n, n, window))
    assert pos.dtype == bias.dtype == torch.float32
    assert fmt_mod.sinusoid_pos_embed(n, d, cpu) is pos
    assert fmt_mod.alignment_bias(n, n, window, cpu) is bias
    with torch.inference_mode():          # made outside inference mode
        assert not fmt_mod.sinusoid_pos_embed(n + 1, d, cpu).is_inference()


@pytest.mark.parametrize("dynamic", [False, True])
def test_eager_latents_equal_those_with_tables_made_per_call(
        pipe, monkeypatch, dynamic):
    r_s, wa, we = _conditions(CFG, 25, dynamic=dynamic, seed=4)

    def sample():
        return sampling.sample_motion_latents(
            pipe.params["fmt"], r_s, wa, we, cfg=CFG,
            generator=torch.Generator().manual_seed(7), **SCALES)
    cached = sample()
    monkeypatch.setattr(fmt_mod, "sinusoid_pos_embed", _old_pos_embed)
    monkeypatch.setattr(fmt_mod, "alignment_bias", _old_bias)
    assert torch.equal(sample(), cached)


class _StandIn:
    """A CUDA graph's part played on the CPU: static copies of the
    inputs and of the scales (float64 tensors, as the graph holds them),
    and a replay that runs the eager chunk on them into one static
    output."""

    def __init__(self, fmt_params, inputs, scales, kw):
        self.inputs = [t.clone() for t in inputs]
        self.scales = torch.tensor(scales, dtype=torch.float64)
        self.fmt, self.kw, self.out = fmt_params, kw, None

    def __call__(self, inputs, scales):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.scales.copy_(torch.tensor(scales, dtype=torch.float64))
        r_s, wa_t, we_t, x0, *carry = self.inputs
        a_s, e_s, r_sc = self.scales
        got = sampling.sample_motion_chunk(
            self.fmt, r_s, wa_t, we_t, tuple(carry), x0, a_cfg_scale=a_s,
            e_cfg_scale=e_s, r_cfg_scale=r_sc, **self.kw)[0]
        if self.out is None:
            self.out = got
        else:
            self.out.copy_(got)
        return self.out.clone()


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: chunk_graphs as on a card, _StandIn for
    the capture."""
    real = sampling.chunk_graphs
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(sampling, "_ChunkGraph", _StandIn)
    monkeypatch.setattr(sampling, "chunk_graphs", lambda p, _d: real(
        p, torch.device("cuda")))


@pytest.mark.parametrize("dynamic", [False, True])
def test_the_graph_paths_bookkeeping(pipe, graphed, monkeypatch, dynamic):
    """Static buffers copied in, the output copied out: each chunk in
    storage of its own, equal to the eager chunk; one capture a key, a
    replay a chunk, graphed = 1; the cache sits on the FMT's tree."""
    fmt = ParamTree(init_fmt(CFG, seed=11))
    r_s, wa, we = _conditions(CFG, 25, dynamic=dynamic, seed=5)

    def chunks(params):
        with torch.inference_mode():
            return list(sampling.sample_motion_chunks(
                params, r_s, wa, we, cfg=CFG,
                generator=torch.Generator().manual_seed(9), **SCALES))
    made = _captures(monkeypatch)
    got, spans = _chunk_spans(lambda: chunks(fmt))
    assert [s.attrs["graphed"] for s in spans] == [1, 1, 1]
    assert len(made) == 1
    assert len({c.data_ptr() for c in got}) == 3
    want = chunks(_plain(init_fmt(CFG, seed=11)))   # a plain dict: eager
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert list(fmt.chunk_graphs.graphs) == [_key(dynamic=dynamic)]
    assert chunks(fmt)[2].equal(got[2])             # the same key again
    assert len(fmt.chunk_graphs.graphs) == 1


MIXED = [dict(a_cfg_scale=1.3, e_cfg_scale=0.7, r_cfg_scale=1.0),
         dict(a_cfg_scale=2.0, e_cfg_scale=1.0, r_cfg_scale=1.0),
         dict(a_cfg_scale=2.7, e_cfg_scale=1.45, r_cfg_scale=1.0),
         dict(a_cfg_scale=1.0, e_cfg_scale=1.0, r_cfg_scale=1.0)]


def test_requests_with_their_own_scales_share_their_modes_graph(graphed,
                                                                monkeypatch):
    """Scales that change from request to request: one capture for the
    3-way mode and one for 'skip' (every scale 1.0), and every request
    equal to its eager latents."""
    fmt = ParamTree(init_fmt(CFG, seed=13))
    plain = _plain(init_fmt(CFG, seed=13))
    r_s, wa, we = _conditions(CFG, 25, seed=6)

    def sample(params, scales):
        with torch.inference_mode():
            return sampling.sample_motion_latents(
                params, r_s, wa, we, cfg=CFG,
                generator=torch.Generator().manual_seed(2), **scales)
    made = _captures(monkeypatch)
    for scales in MIXED + MIXED[:1]:
        assert torch.equal(sample(fmt, scales), sample(plain, scales))
    assert len(made) == 2
    assert [k[4] for k in fmt.chunk_graphs.graphs] == ["skip", "3way"]


def _cfg_outputs(n_way, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3 * torch.randn(n_way, 12, 64, generator=g)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["3way", "4way"])
def test_tensor_scales_combine_as_numbers_do(monkeypatch, dtype, mode):
    """The CFG combination with float64 0-dim scales, as a graph reads
    them, equals the one with Python numbers bit for bit, in every
    sampler dtype (scales no 16-bit float holds)."""
    n_way = 4 if mode == "4way" else 3
    out = _cfg_outputs(n_way, dtype)
    monkeypatch.setattr(fmt_mod, "fmt_forward", lambda *a, **k: out)
    scales = dict(a_cfg_scale=1.3, e_cfg_scale=0.7, r_cfg_scale=2.9)
    x = torch.zeros(1, 12, 64, dtype=dtype)
    args = (None, None, x, x, x[:, 0], x, x, x, None)
    kw = dict(cfg_mode=mode, include_r_cfg=n_way == 4, depth=1,
              num_heads=1, attention_window=1)
    want = fmt_mod.fmt_forward_cfg(*args, **scales, **kw)
    got = fmt_mod.fmt_forward_cfg(*args, **kw, **{
        k: torch.tensor(v, dtype=torch.float64) for k, v in scales.items()})
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


def test_weights_in_new_storage_drop_the_graphs(graphed):
    fmt = ParamTree(init_fmt(CFG, seed=12))
    r_s, wa, we = _conditions(CFG, 10)

    def sample():
        return sampling.sample_motion_latents(
            fmt, r_s, wa, we, cfg=CFG,
            generator=torch.Generator().manual_seed(3), **SCALES)
    first = sample()
    graph = next(iter(fmt.chunk_graphs.graphs.values()))
    fmt.to(torch.float64).to(torch.float32)        # new storage, same values
    assert torch.equal(sample(), first)
    assert next(iter(fmt.chunk_graphs.graphs.values())) is not graph


# -- on the card ------------------------------------------------------------

C1 = FloatConfig()                   # config 1: dim_h 1024, 8 blocks


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False    # as a pipeline sets
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_fmt(device, seed):
    """Config 1's FMT with weights drawn on the card."""
    class Draw:
        def __init__(self, _seed, scale=0.05):
            self.g = torch.Generator(device=device).manual_seed(seed)
            self.scale = scale

        def t(self, *shape, scale=None):
            s = self.scale if scale is None else scale
            return s * torch.randn(shape, generator=self.g, device=device)

        def zeros(self, *shape):
            return torch.zeros(shape, device=device)

        ones = zeros
    return ParamTree(init_fmt(C1, mk=Draw))


def _card_sample(fmt, device, t, dynamic=False, seed=0):
    r_s, wa, we = _conditions(C1, t, dynamic=dynamic, device=device,
                              seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    return sampling.sample_motion_chunks(fmt, r_s, wa, we, cfg=C1,
                                         generator=gen)


def _eager(monkeypatch):
    monkeypatch.setattr(sampling, "chunk_graphs", lambda *a: None)


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_replayed_chunks_equal_eager_ones_bit_for_bit(card, monkeypatch,
                                                      dynamic):
    """A 3-chunk clip (the last chunk edge-padded) and a stream, each
    chunk taken while card work of the consumer runs between chunks:
    every chunk equal to the eager chunk, and each in storage of its
    own, which later replays leave as it was."""
    fmt = _card_fmt(card, 1)
    t = 2 * C1.num_frames_for_clip + 17

    def replayed():
        kept, copies = [], []
        for c in _card_sample(fmt, card, t, dynamic):
            kept.append(c)
            copies.append(c.clone())
            torch.relu(c @ c.transpose(1, 2)).sum()   # the consumer's work
        clip = torch.cat(list(_card_sample(fmt, card, t, dynamic)), dim=1)
        return kept, copies, clip
    with torch.inference_mode():
        (kept, copies, clip), spans = _chunk_spans(replayed)
        _eager(monkeypatch)
        want = list(_card_sample(fmt, card, t, dynamic))
    assert [s.attrs["graphed"] for s in spans] == [1] * 6
    assert len({c.data_ptr() for c in kept}) == 3
    assert all(torch.equal(a, b) for a, b in zip(kept, copies))
    assert all(torch.equal(a, b) for a, b in zip(kept, want))
    assert torch.equal(clip, torch.cat(want, dim=1))


@pytest.mark.cuda
def test_replays_with_each_requests_scales_equal_eager_ones(card,
                                                            monkeypatch):
    """Scales that change from request to request on config 1: one
    capture for the 3-way mode and one for 'skip', every clip equal to
    its eager clip bit for bit."""
    fmt = _card_fmt(card, 4)

    def clip(scales):
        r_s, wa, we = _conditions(C1, 60, device=card, seed=3)
        gen = torch.Generator(device=card).manual_seed(103)
        return sampling.sample_motion_latents(fmt, r_s, wa, we, cfg=C1,
                                              generator=gen, **scales)
    made = _captures(monkeypatch)
    with torch.inference_mode():
        got = [clip(s) for s in MIXED + MIXED[:1]]
        assert len(made) == 2
        _eager(monkeypatch)
        want = [clip(s) for s in MIXED + MIXED[:1]]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_tensor_scales_combine_as_numbers_do_on_the_card(card, monkeypatch,
                                                         dtype):
    """As on the CPU, and the control: a float64 scale multiplied into a
    16-bit tensor as it is, which the kernel rounds to 16 bits, differs
    from the number."""
    out = _cfg_outputs(3, dtype).to(card)
    monkeypatch.setattr(fmt_mod, "fmt_forward", lambda *a, **k: out)
    scales = dict(a_cfg_scale=1.3, e_cfg_scale=0.7)
    x = torch.zeros(1, 12, 64, dtype=dtype, device=card)
    args = (None, None, x, x, x[:, 0], x, x, x, None)
    kw = dict(cfg_mode="3way", depth=1, num_heads=1, attention_window=1)
    want = fmt_mod.fmt_forward_cfg(*args, **scales, **kw)
    tensors = {k: torch.tensor(v, dtype=torch.float64, device=card)
               for k, v in scales.items()}
    assert torch.equal(fmt_mod.fmt_forward_cfg(*args, **kw, **tensors), want)
    d = out[2] - out[0]
    naive = d * tensors["a_cfg_scale"]
    assert torch.equal(naive, 1.3 * d) == (dtype not in (torch.float16,
                                                         torch.bfloat16))


@pytest.mark.cuda
def test_two_trees_capture_at_once_from_two_threads(card):
    """Captures share their device's side stream, one at a time."""
    import threading
    fmts = [_card_fmt(card, 5), _card_fmt(card, 6)]
    got, errors = {}, []
    start = threading.Barrier(2)

    def run(i):
        try:
            with torch.inference_mode():
                start.wait()
                got[i] = torch.cat(list(_card_sample(fmts[i], card, 60)), 1)
                torch.cuda.synchronize(card)
        except Exception as e:            # reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    with torch.inference_mode():
        for i, fmt in enumerate(fmts):
            assert torch.equal(
                got[i], torch.cat(list(_card_sample(fmt, card, 60)), 1))


@pytest.mark.cuda
def test_a_second_tree_captures_its_own_graphs(card):
    one, two = _card_fmt(card, 1), _card_fmt(card, 2)
    with torch.inference_mode():
        a = list(_card_sample(one, card, 30))
        b = list(_card_sample(two, card, 30))
    assert one.chunk_graphs is not two.chunk_graphs
    assert len(one.chunk_graphs.graphs) == len(two.chunk_graphs.graphs) == 1
    (g1,), (g2,) = (t.chunk_graphs.graphs.values() for t in (one, two))
    assert g1.graph is not g2.graph
    assert not torch.equal(a[0], b[0])


def _reserved(device) -> int:
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


@pytest.mark.cuda
def test_freeing_the_weights_frees_their_graphs(card):
    """Reserved memory after a tree, its graphs and its chunks are freed
    is back where it was before the tree: the graphs' pool went with it.
    A first round makes what stays for the process (the capture stream's
    cuBLAS workspace, the FMT's tables)."""
    def round_():
        fmt = _card_fmt(card, 3)
        with torch.inference_mode():
            out = list(_card_sample(fmt, card, 50))
        held = _reserved(card)
        assert fmt.chunk_graphs.graphs
        del fmt, out
        return held
    round_()
    base = _reserved(card)
    held = round_()
    assert held > base
    assert _reserved(card) <= base
