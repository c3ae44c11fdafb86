"""The decode's chunk graphs (``float_torch.runtime.decode``): which inputs
key a graph, where the chunks run eagerly, the launch counters under
capture and replay, the constants made once a device, and the graph
path's bookkeeping on the CPU with a stand-in for the CUDA graph.  The
``cuda`` tests hold every decode path's replayed frames to its eager
frames at config 1's decode on the card.  Imports neither JAX nor
float_tpu, so the card tests run on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py``.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from float_torch import kernels
from float_torch.config import FloatConfig, Wav2Vec2Config
from float_torch.kernels import flow_merge as k8
from float_torch.models.init import ParamTree, init_pipeline, init_synthesis
from float_torch.ops import upfirdn
from float_torch.runtime import decode
from float_torch.runtime.cuda_graphs import cache_on
from float_torch.runtime.pipeline import FloatPipeline, _nest
from float_torch.utils import profiling

SMALL = {4: 16, 8: 16, 16: 16, 32: 16, 64: 16}


def _small(seed=3) -> dict:
    """A 64² synthesis with 16 channels a level, as numpy arrays."""
    from float_torch.models import init
    mp = pytest.MonkeyPatch()
    mp.setattr(init, "CHANNELS_MAP", SMALL)
    try:
        return init_synthesis(64, 32, 20, seed=seed)
    finally:
        mp.undo()


def _tree(seed=3) -> ParamTree:
    return ParamTree(_small(seed))


def _plain(tree):
    """A nested dict of tensors (no ParamTree): no graphs."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


@pytest.fixture(scope="module")
def tiny():
    """The small synthesis, batch-1 skip maps of two portraits, s_r and
    13 motion latents."""
    g = torch.Generator().manual_seed(4)

    def maps():
        return [0.5 * torch.randn(1, SMALL[r], r, r, generator=g)
                for r in (8, 16, 32, 64)]
    return dict(params=_tree(), feats=maps(), feats2=maps(),
                s_r=0.3 * torch.randn(1, 32, generator=g),
                r_d=0.3 * torch.randn(13, 32, generator=g))


def _key(b=8, dtype=torch.float32, size=64, out_u8=False,
         rgb_in_kernel=False, blur_kernel=(1, 3, 3, 1), maps_b=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    wa = torch.randn(b, 32, generator=g).to(dtype)
    feats = [torch.randn(maps_b, SMALL[r], r, r, generator=g)
             for r in (8, 16, 32, 64)]
    return decode.decode_graph_key(wa, feats, size=size, out_u8=out_u8,
                                   rgb_in_kernel=rgb_in_kernel,
                                   blur_kernel=blur_kernel)


KEYED = {"frames": dict(b=12), "one_frame": dict(b=1),
         "dtype": dict(dtype=torch.bfloat16), "size": dict(size=128),
         "u8": dict(out_u8=True), "yuv420": dict(out_u8="yuv420"),
         "rgb_in_kernel": dict(rgb_in_kernel=True),
         "blur": dict(blur_kernel=(1, 2, 1)), "maps_per_frame": dict(maps_b=8)}


@pytest.mark.parametrize("change", sorted(KEYED))
def test_each_keyed_input_changes_the_key(change):
    assert _key(**KEYED[change]) != _key()


def test_the_portrait_and_the_latents_do_not():
    """Two clips of one shape with other portraits and latents."""
    assert _key(seed=1) == _key(seed=2)
    assert _key(out_u8="yuv420", seed=1) == _key(out_u8="yuv420", seed=2)
    assert _key(out_u8=True) == _key(out_u8=1)


def _fake_launch(name="warp_shared", shape=(8, 64, 64, 16)):
    """What a kernel wrapper counts for one launch."""
    kernels.LAUNCHES[name] += 1
    kernels.LAUNCH_SHAPES[(name, *shape)] += 1


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_capture_counts_nothing_and_each_replay_its_launches(monkeypatch):
    """The launches counted under capture are taken back out, those of
    kernels new to the counters too (no zero entries left), and each
    replay adds exactly them again; eager launches count as before."""
    monkeypatch.setattr(kernels, "LAUNCHES", Counter({"styled_tail": 3}))
    monkeypatch.setattr(kernels, "LAUNCH_SHAPES", Counter(
        {("styled_tail", 8, 8, 8, 16): 3}))
    before = Counter(kernels.LAUNCHES), Counter(kernels.LAUNCH_SHAPES)
    with kernels.CapturedLaunches() as captured:
        _fake_launch()
        _fake_launch()
        _fake_launch("styled_tail", (8, 8, 8, 16))
    assert (kernels.LAUNCHES, kernels.LAUNCH_SHAPES) == before
    assert "warp_shared" not in kernels.LAUNCHES
    graph = _Graph()
    for n in (1, 2):
        captured.replay(graph)
        assert graph.replays == n
        assert kernels.LAUNCHES == Counter(
            {"styled_tail": 3 + n, "warp_shared": 2 * n})
        assert kernels.LAUNCH_SHAPES == Counter(
            {("styled_tail", 8, 8, 8, 16): 3 + n,
             ("warp_shared", 8, 64, 64, 16): 2 * n})
    _fake_launch()
    assert kernels.LAUNCHES["warp_shared"] == 5


def _chunk_spans(run):
    profiling.tracing_on()
    try:
        out = run()
        spans = sorted((s for s in profiling.take().spans
                        if s.name == "decode.chunk"),
                       key=lambda s: s.start_ns)
    finally:
        profiling.tracing_off()
    return out, spans


def _decode(tiny, params=None, **kw):
    with torch.inference_mode():
        return decode.decode_latents(
            tiny["params"] if params is None else params, tiny["s_r"],
            tiny["feats"], tiny["r_d"], size=64, decode_batch=8, **kw)


def test_no_graph_where_none_applies(tiny):
    """A CPU device, weights not whole on the chunk's device, or not in a
    ParamTree: no graphs, on a card either (a capture under way: the
    card tests)."""
    card = torch.device("cuda", 0)
    assert decode.decode_graphs(tiny["params"], torch.device("cpu")) is None
    assert decode.decode_graphs(tiny["params"], card) is None
    assert decode.decode_graphs(_plain(_small()), card) is None
    assert tiny["params"].decode_graphs is None


@pytest.mark.parametrize("path", ["cpu", "frame parallel"])
def test_cpu_and_frame_parallel_decodes_stay_eager(tiny, path):
    """graphed = 0 on every chunk, and no graphs made."""
    kw = {} if path == "cpu" else dict(
        chunk_fn=decode.FrameParallel(["cpu", "cpu"]))
    frames, spans = _chunk_spans(lambda: _decode(tiny, **kw))
    assert frames.shape == (13, 64, 64, 3)
    assert [s.attrs["graphed"] for s in spans] == [0, 0]
    assert tiny["params"].decode_graphs is None


class _StandIn:
    """A decode graph's part played on the CPU: a static copy of the
    latents over the shared static maps, the eager chunk as the first
    chunk's frames, and a replay that runs the eager chunk on the static
    buffers into one static output."""
    made = []

    def __init__(self, params, wa, maps, kw, pool):
        self.wa, self.maps, self.pool = wa.clone(), maps, pool
        self.params, self.kw, self.out = params, kw, None
        self.first = decode.decode_chunk(params, self.wa, maps.tensors, **kw)
        self.made.append(decode.decode_graph_key(wa, maps.tensors, **kw))

    def __call__(self, wa):
        if self.first is not None:
            out, self.first = self.first, None
            return out, False
        self.wa.copy_(wa)
        got = decode.decode_chunk(self.params, self.wa, self.maps.tensors,
                                  **self.kw)
        if self.out is None:
            self.out = got
        else:
            self.out.copy_(got)
        return self.out.clone(), True

    def order_after(self):
        pass


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: a ParamTree's graphs as on a card,
    _StandIn for the capture, and the maps' writes counted."""
    monkeypatch.setattr(decode, "decode_graphs", lambda p, _d: (
        cache_on(p, "decode_graphs", decode.DecodeGraphs)
        if isinstance(p, ParamTree) else None))
    monkeypatch.setattr(decode, "_DecodeGraph", _StandIn)
    monkeypatch.setattr(_StandIn, "made", [])
    loads, load = [], decode._Maps.load

    def counted(maps, clip):
        before = maps.owner
        load(maps, clip)
        loads.append(maps.owner is not before)
    monkeypatch.setattr(decode._Maps, "load", counted)
    return loads


def test_the_graph_paths_bookkeeping(tiny, graphed):
    """One capture a key (8 and the last chunk's 8: one key), whose
    chunk keeps its eager frames (graphed 0), a replay each later chunk
    (graphed 1), each chunk in storage of its own, the frames equal to
    the eager decode, the maps written once a clip, and the cache on the
    synthesis' tree."""
    params = _tree()
    got, spans = _chunk_spans(lambda: _decode(tiny, params))
    want = _decode(tiny, _plain(_small()))
    assert torch.equal(got, want)
    assert [s.attrs["graphed"] for s in spans] == [0, 1]
    assert len(_StandIn.made) == 1
    assert list(params.decode_graphs.graphs) == _StandIn.made
    assert graphed == [True, False]
    again, spans = _chunk_spans(lambda: _decode(tiny, params))
    assert torch.equal(again, want)
    assert [s.attrs["graphed"] for s in spans] == [1, 1]
    assert graphed == [True, False, True, False]


def test_each_clip_of_a_batch_reads_its_own_maps(tiny, graphed):
    """Two portraits in one dispatch stream on the same keys: the second
    clip's maps replace the first's at its first chunk, and every host
    chunk equals its clip's eager frames."""
    params = _tree()
    clips = [(tiny["s_r"], tiny["feats"], tiny["r_d"]),
             (tiny["s_r"] * 0.5, tiny["feats2"], tiny["r_d"][:10])]

    def run(p):
        return decode.decode_clips_to_host(p, clips, size=64, decode_batch=8,
                                           uint8_transfer=False)
    got = run(params)
    want = run(_plain(_small()))
    assert [g.shape[0] for g in got] == [13, 10]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert graphed == [True, False, True, False]
    assert len(_StandIn.made) == 2                  # chunks of 8 and of 4
    assert len(params.decode_graphs.maps) == 1      # shared by both


@pytest.mark.parametrize("emit", ["u8", "yuv420"])
def test_the_stream_replays_with_its_own_wire(tiny, graphed, emit):
    params = _tree()

    def run(p):
        pieces = [tiny["r_d"][i:i + 5] for i in range(0, 13, 5)]
        return list(decode.decode_latents_stream(
            p, tiny["s_r"], tiny["feats"], iter(pieces), size=64,
            decode_batch=8, first_chunk=4, emit=emit))
    got, spans = _chunk_spans(lambda: run(params))
    want = run(_plain(_small()))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 4, 12]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
    assert [s.attrs["graphed"] for s in spans] == [0, 0, 1]
    assert [k[5] for k in _StandIn.made] == [emit == "u8" or emit] * 2


def test_weights_in_new_storage_drop_the_graphs(tiny, graphed):
    params = _tree()
    first = _decode(tiny, params)
    graph = next(iter(params.decode_graphs.graphs.values()))
    params.to(torch.float64).to(torch.float32)      # new storage, same values
    assert torch.equal(_decode(tiny, params), first)
    assert next(iter(params.decode_graphs.graphs.values())) is not graph


@pytest.mark.parametrize("taps, factor", [((1, 3, 3, 1), 1),
                                          ((1, 3, 3, 1), 2), ((1, 2, 1), 2)])
def test_blur_taps_are_made_once_a_device(taps, factor):
    k = np.outer(taps, taps).astype(np.float32)
    want = torch.from_numpy(k / k.sum() * (factor ** 2 if factor > 1 else 1))
    got = upfirdn.make_blur_kernel(taps, factor, device=torch.device("cpu"))
    assert torch.equal(got, want)
    assert upfirdn.make_blur_kernel(list(taps), factor,
                                    device=torch.device("cpu")) is got
    with torch.inference_mode():          # made outside inference mode
        assert not upfirdn.make_blur_kernel(
            taps, factor + 2, device=torch.device("cpu")).is_inference()


# -- on the card ------------------------------------------------------------

W2V = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
           conv_stride=(5, 2, 2), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
C1 = FloatConfig(compute_dtype="bfloat16", decode_batch=24)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pipe(card):
    """Config 1's decode (512², bf16, 24-frame chunks) and FMT behind
    tiny audio towers, its weights drawn on the card."""
    class Draw:
        def __init__(self, seed, scale=0.05):
            self.g = torch.Generator(device=card).manual_seed(seed)
            self.scale = scale

        def t(self, *shape, scale=None):
            s = self.scale if scale is None else scale
            return s * torch.randn(shape, generator=self.g, device=card)

        def zeros(self, *shape):
            return torch.zeros(shape, device=card)

        def ones(self, *shape):
            return torch.ones(shape, device=card)
    w2v = Wav2Vec2Config(feat_extract_norm="group", conv_bias=False,
                         do_stable_layer_norm=False, **W2V)
    ser = Wav2Vec2Config(feat_extract_norm="layer", conv_bias=True,
                         do_stable_layer_norm=True, num_labels=7, **W2V)
    tree = ParamTree(init_pipeline(C1, w2v, ser, seed=7, mk=Draw))
    return FloatPipeline(tree, C1, w2v, ser, device=card)


def _inputs(card, seconds, seed):
    g = torch.Generator().manual_seed(seed)
    img = 0.3 * torch.randn(1, 3, 512, 512, generator=g)
    wave = 0.1 * torch.randn(1, seconds * 16000, generator=g)
    return img.to(card), wave.to(card)


@pytest.fixture(scope="module")
def clip10(card, pipe):
    """A 10 s clip's inputs, its source latents and its motion latents."""
    img, wave = _inputs(card, 10, seed=1)
    with torch.inference_mode():
        s_r, _lam, feats, r_s = pipe.encode_image(img)
        wa = pipe.encode_audio(wave, 250)
        we = pipe.emotion_latent(wave, "none")
        r_d = pipe.sample(r_s, wa, we, seed=3)
    return dict(img=img, wave=wave, s_r=s_r, feats=feats, r_d=r_d)


def _eager_and_graphed(monkeypatch, run):
    """(eager result, its launch counts, graphed result, its counts,
    decode.chunk spans of the graphed run): ``run`` with the decode's
    graphs off, then on; counts as (LAUNCHES, LAUNCH_SHAPES)."""
    out = []
    real = decode.decode_graphs
    for graphs in (lambda *a: None, real):
        monkeypatch.setattr(decode, "decode_graphs", graphs)
        kernels.LAUNCHES.clear()
        kernels.LAUNCH_SHAPES.clear()
        got, spans = _chunk_spans(run)
        torch.cuda.synchronize()
        out += [got, (dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES))]
    return (*out, spans)


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


PATHS = {
    "generate": lambda p, c: p.generate(c["img"], c["wave"], seed=3),
    "decode": lambda p, c: p.decode(c["s_r"], c["feats"], c["r_d"]),
    "decode_to_host": lambda p, c: p.decode_to_host(c["s_r"], c["feats"],
                                                    c["r_d"]),
    "stream u8": lambda p, c: [f for _s, f in p.generate_stream(
        c["img"], c["wave"], seed=3, first_chunk=8, wire="u8")],
    "stream yuv420": lambda p, c: [f for _s, f in p.generate_stream(
        c["img"], c["wave"], seed=3, first_chunk=8, wire="yuv420")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_path_replays_the_eager_frames(pipe, clip10, monkeypatch, path):
    """A 10 s clip (10 chunks of 24 and one of 12; a stream's ramp of 8,
    then 24s): frames equal to the eager decode's bit for bit, the same
    launch counts by kernel and shape, and every chunk replayed once
    its keys are captured."""
    run = PATHS[path]
    run(pipe, clip10)                             # its keys captured
    eager, n_eager, got, n_got, spans = _eager_and_graphed(
        monkeypatch, lambda: run(pipe, clip10))
    assert _equal(got, eager)
    assert n_got == n_eager
    assert n_got[0]["warp_shared"] == 7 * len(spans) > 0
    assert [s.attrs["graphed"] for s in spans] == [1] * len(spans)


def _todays_epilogues(monkeypatch) -> None:
    """The decode's op sequence before K7 wrote the modulations and K8 the
    flow merges: K7's tails alone, each modulation and each merge as the
    plain ops right after them."""
    from float_torch.kernels import styled_tail as k7
    from float_torch.ops import tails
    real = k7.styled_tail_cuda

    def tail(x, demod, bias, up, scale=None, scale2=None):
        y = real(x, demod, bias, up)
        y2 = None if scale2 is None else tails.modulate(y, scale2)
        if scale is not None:
            y = tails.modulate(y, scale)
        return y if scale2 is None else (y, y2)
    monkeypatch.setattr(k7, "styled_tail_cuda", tail)
    monkeypatch.setattr(k8, "flow_merge_cuda", tails.flow_merge_ref)


def _frames(got) -> torch.Tensor:
    """A path's frames (a tensor, an array or a list of either) as one
    float tensor in [0, 1] on the host."""
    if isinstance(got, (list, tuple)):
        got = torch.cat([_frames(g) for g in got])
    got = got.cpu() if torch.is_tensor(got) else torch.from_numpy(
        np.asarray(got))
    return got.float() / 255.0 if got.dtype == torch.uint8 else got.float()


TODAY_PATHS = dict(
    PATHS,
    batch=lambda p, c: p.generate_batch(
        torch.cat([c["img"], c["img"].flip(-1)]),
        [c["wave"][0], c["wave"][0, :96000]]),
    one_frame=lambda p, c: decode.decode_latents(
        p.syn_cast, c["s_r"], c["feats"], c["r_d"][0, :8], size=512,
        decode_batch=1, compute_dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(TODAY_PATHS))
def test_each_path_keeps_todays_frames(pipe, clip10, monkeypatch, path):
    """Each decode path, replayed and eager, against the same decode with
    every modulation and merge as plain ops after K7 (eager): frames
    within the bf16 decode tolerance (chip_smoke's ``DECODE_TOL``, the
    tolerance of a kernel warp against the plain one), the same K1, K3
    and K7 launches, and K8 once each K1 or K3 warp."""
    import chip_smoke
    run = TODAY_PATHS[path]

    def counted():
        kernels.LAUNCHES.clear()
        with torch.inference_mode():
            got = _frames(run(pipe, clip10))
        return got, dict(kernels.LAUNCHES)
    run(pipe, clip10)                             # its keys captured
    graphed, n_graphed = counted()
    monkeypatch.setattr(decode, "decode_graphs", lambda *a: None)
    eager, n_eager = counted()
    _todays_epilogues(monkeypatch)
    today, n_today = counted()
    for got, n in ((graphed, n_graphed), (eager, n_eager)):
        assert got.shape == today.shape
        assert (got - today).abs().max().item() <= chip_smoke.DECODE_TOL
        merges = sum(n.pop(k, 0) for k in (k8.NAME, k8.NAME_LAST))
        assert merges == n.get("warp_shared", 0) + n.get(
            "warp_per_frame", 0) > 0
        assert n == n_today


@pytest.mark.cuda
def test_a_ragged_batch_of_two_portraits(card, pipe, monkeypatch):
    """10 s and 6 s of audio, two portraits, one dispatch stream, every
    key new: the second clip reads its own maps, and the counts are the
    eager path's, captures included (a key's first chunk is its eager
    run, the capture counts nothing)."""
    img, wave = _inputs(card, 10, seed=2)
    img2, wave2 = _inputs(card, 6, seed=5)
    pipe.syn_cast.decode_graphs = None

    def run():
        return pipe.generate_batch(torch.cat([img, img2]),
                                   [wave[0], wave2[0]])
    eager, n_eager, got, n_got, spans = _eager_and_graphed(monkeypatch, run)
    assert _equal(got, eager)
    assert n_got == n_eager
    assert [s.attrs["graphed"] for s in spans].count(0) == 3   # 24, 12, 8
    assert len(pipe.syn_cast.decode_graphs.maps) == 1


@pytest.mark.cuda
def test_one_frame_chunks(card, pipe, clip10, monkeypatch):
    """decode_batch=1: every level warps per frame (K3), on one key."""
    def run():
        with torch.inference_mode():
            return decode.decode_latents(
                pipe.syn_cast, clip10["s_r"], clip10["feats"],
                clip10["r_d"][0, :40], size=512, decode_batch=1,
                compute_dtype=torch.bfloat16)
    eager, n_eager, got, n_got, spans = _eager_and_graphed(monkeypatch, run)
    assert torch.equal(got, eager)
    assert n_got == n_eager
    assert n_got[0] == {"warp_per_frame": 280, "styled_tail": 1080,
                        "flow_merge": 240, "flow_merge_last": 40}
    assert [s.attrs["graphed"] for s in spans] == [0] + [1] * 39


@pytest.mark.cuda
def test_host_bytes_outlive_the_next_replay(card, pipe, clip10,
                                            monkeypatch):
    """Through the in-flight wire, chunk c's host bytes are chunk c's
    while chunk c+1 replays with card work queued between: the frames
    handed out are never the graph's static output."""
    big = torch.randn(4096, 4096, device=card)

    def run():
        outs, apart = [], []
        with torch.inference_mode():
            chunks = decode._run_chunks(
                pipe.syn_cast, clip10["s_r"], clip10["feats"],
                [clip10["r_d"][0, :96]], [24] * 4, size=512,
                compute_dtype=torch.bfloat16, out_u8=True)

            def tagged():
                for lo, _n, dev in chunks:
                    graphs = pipe.syn_cast.decode_graphs
                    if graphs is not None and graphs.last is not None:
                        apart.append(graphs.last.out.data_ptr()
                                     != dev.data_ptr())
                    yield lo, dev
                    (big @ big).sum()            # the consumer's card work
            for _lo, host in decode._in_flight(tagged()):
                outs.append(host.copy())
        assert all(apart)
        return np.concatenate(outs)
    run()
    eager, _n, got, _m, spans = _eager_and_graphed(monkeypatch, run)
    assert np.array_equal(got, eager)
    assert [s.attrs["graphed"] for s in spans] == [1] * 4


@pytest.mark.cuda
def test_the_graphs_share_one_pool(card, pipe, clip10):
    """A fresh tree's two keys: one pool, made at the first capture."""
    syn = ParamTree(_nest({k: v.clone() for k, v in
                           pipe.syn_cast.state_dict().items()}))
    with torch.inference_mode():
        decode.decode_latents(syn, clip10["s_r"], clip10["feats"],
                              clip10["r_d"][0, :30], size=512,
                              decode_batch=24, compute_dtype=torch.bfloat16)
    graphs = list(syn.decode_graphs.graphs.values())
    assert len(graphs) == 2 and syn.decode_graphs.pool is not None
    assert graphs[0].pool == graphs[1].pool == syn.decode_graphs.pool


@pytest.mark.cuda
def test_no_graph_under_a_capture(card, pipe):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(card)):
        torch.zeros(1, device=card).add_(1)
        inside = decode.decode_graphs(pipe.syn_cast, card)
    assert inside is None
    assert decode.decode_graphs(pipe.syn_cast, card) is not None
