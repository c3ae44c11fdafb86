"""The port's span recorder (``float_torch.utils.profiling``) on the tiny
CPU config: off it records nothing and opens no profiler range; on, the
runtime's spans have the named layers, parents, request ids and chunk
counts, lie on the profiler's clock, never hold a consumer's time, and
leave the frames as they were."""
import math
import time

import numpy as np
import pytest
import torch

from float_torch.config import FloatConfig, Wav2Vec2Config
from float_torch.runtime.decode import chunk_sizes, stream_chunk_count
from float_torch.runtime.pipeline import (audio_num_frames,
                                          build_synthetic_pipeline)
from float_torch.utils import profiling

W2V = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
           conv_stride=(5, 2, 2), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
CFG = FloatConfig(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
                  dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
                  num_prev_frames=3, decode_batch=4, compute_dtype="float32")
SECONDS = 1.2                   # 30 frames: 3 sampler chunks of 10
FIRST_CHUNK = 4
ENCODERS = {"encode_image", "encode_audio", "emotion"}


@pytest.fixture(scope="module")
def pipe():
    w2v = Wav2Vec2Config(feat_extract_norm="group", conv_bias=False,
                         do_stable_layer_norm=False, **W2V)
    ser = Wav2Vec2Config(feat_extract_norm="layer", conv_bias=True,
                         do_stable_layer_norm=True, num_labels=7, **W2V)
    return build_synthetic_pipeline(CFG, w2v, ser, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = rng.random((1, 3, 64, 64)).astype(np.float32) * 2 - 1
    wave = 0.1 * rng.standard_normal(
        (1, int(SECONDS * CFG.sampling_rate))).astype(np.float32)
    return torch.from_numpy(img), torch.from_numpy(wave)


@pytest.fixture
def tracing():
    profiling.tracing_on()
    yield
    profiling.tracing_off()


def _clip(pipe, inputs):
    img, wave = inputs
    return pipe.generate(img, wave, seed=3)


def _stream(pipe, inputs, pause=0.0, pauses=None):
    img, wave = inputs
    out = []
    for _start, part in pipe.generate_stream(img, wave, seed=3,
                                             first_chunk=FIRST_CHUNK,
                                             wire="u8"):
        out.append(part)
        if pause:
            t0 = time.time_ns()
            time.sleep(pause)
            pauses.append((t0, time.time_ns()))
    return np.concatenate(out)


RUNS = {"generate": _clip, "generate_stream": _stream}


def _frames():
    return audio_num_frames(int(SECONDS * CFG.sampling_rate), CFG)


def test_off_records_nothing_and_opens_no_range(pipe, inputs):
    profiling.tracing_off()
    assert profiling.span("x", index=1) is profiling.span("y")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _clip(pipe, inputs)
        _stream(pipe, inputs)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith("float.")]
    assert profiling.take() == ([], 0)


@pytest.mark.parametrize("entry", sorted(RUNS))
def test_named_spans_parents_and_one_request(pipe, inputs, tracing, entry):
    RUNS[entry](pipe, inputs)
    RUNS[entry](pipe, inputs)
    spans = profiling.take().spans
    roots = [s for s in spans if s.name == entry]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert roots[0].request != roots[1].request
    assert {s.request for s in spans} == {r.request for r in roots}
    one = [s for s in spans if s.request == roots[0].request]
    by_id = {s.id: s for s in one}
    names = {s.name for s in one}
    assert names >= ENCODERS | {"direction_qr", "sample.chunk",
                                "decode.chunk"}
    for s in one:
        if s.name in ENCODERS:
            assert s.parent == roots[0].id
        if s.name == "direction_qr":
            assert by_id[s.parent].name == "encode_image"
        if s.parent is not None:        # a child lies inside its parent
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    chunks = [s for s in one if s.name in ("sample.chunk", "decode.chunk")]
    if entry == "generate":
        assert all(s.parent == roots[0].id for s in chunks)
    else:
        # the root ends at the first yield: chunks made later have no
        # open parent, and keep the request's id
        first = [s for s in chunks if s.parent == roots[0].id]
        assert first and len(first) < len(chunks)
        assert all(s.parent is None for s in chunks if s not in first)
        assert all(s.start_ns >= roots[0].end_ns for s in chunks
                   if s not in first)


@pytest.mark.parametrize("entry", sorted(RUNS))
def test_chunk_counts(pipe, inputs, tracing, entry):
    RUNS[entry](pipe, inputs)
    spans = profiling.take().spans
    t = _frames()
    sample = [s for s in spans if s.name == "sample.chunk"]
    decode = [s for s in spans if s.name == "decode.chunk"]
    assert len(sample) == math.ceil(t / CFG.num_frames_for_clip) == 3
    assert [s.attrs["index"] for s in sample] == [0, 1, 2]
    assert {s.attrs["frames"] for s in sample} == {CFG.num_frames_for_clip}
    if entry == "generate":
        want = chunk_sizes(t, CFG.decode_batch)
        assert [s.attrs["frames"] for s in decode] == want
    else:
        assert len(decode) == stream_chunk_count(t, CFG.decode_batch,
                                                 FIRST_CHUNK)
        assert decode[0].attrs["frames"] == FIRST_CHUNK
    assert [s.attrs["index"] for s in decode] == list(range(len(decode)))


def test_a_sleeping_consumer_lengthens_no_span(pipe, inputs, tracing):
    pauses = []
    _stream(pipe, inputs, pause=0.05, pauses=pauses)
    spans = profiling.take().spans
    assert len(pauses) == stream_chunk_count(_frames(), CFG.decode_batch,
                                             FIRST_CHUNK)
    for s in spans:
        for lo, hi in pauses:
            assert s.end_ns <= lo or s.start_ns >= hi, s


def test_spans_lie_on_the_profilers_clock(pipe, inputs, tracing):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _stream(pipe, inputs)
    spans = profiling.take().spans
    ranges: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("float."):
            ranges.setdefault(ev.name()[len("float."):], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    by_name: dict = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == set(ranges)
    for name, ss in by_name.items():
        rs = sorted(ranges[name])
        assert len(rs) == len(ss)
        for s, (lo, hi) in zip(ss, rs):
            assert abs(s.start_ns - lo) < 1_000_000
            assert abs(s.end_ns - hi) < 1_000_000


@pytest.mark.parametrize("entry", sorted(RUNS))
def test_frames_equal_with_tracing_on_and_off(pipe, inputs, entry):
    profiling.tracing_off()
    off = RUNS[entry](pipe, inputs)
    profiling.tracing_on()
    try:
        on = RUNS[entry](pipe, inputs)
        assert profiling.take().spans
    finally:
        profiling.tracing_off()
    assert torch.equal(torch.as_tensor(on), torch.as_tensor(off))


def test_a_full_buffer_drops_and_counts(monkeypatch, tracing):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    for i in range(5):
        with profiling.span("x", index=i):
            pass
    taken = profiling.take()
    assert [s.attrs["index"] for s in taken.spans] == [0, 1, 2]
    assert taken.dropped == 2
    assert profiling.take() == ([], 0)


def test_resumed_keeps_the_request_and_closes(tracing):
    closed = []

    def work():
        try:
            for i in range(3):
                with profiling.span("piece", index=i):
                    pass
                yield i
        finally:
            closed.append(True)

    with profiling.span("root") as root:
        it = work()
        next(it)
    rest = profiling.resumed(it, root)
    assert next(rest) == 1
    rest.close()
    assert closed == [True]
    with profiling.span("other"):
        pass
    spans = {(s.name, s.attrs.get("index")): s for s in profiling.take().spans}
    assert spans["piece", 1].request == spans["root", None].request
    assert spans["piece", 1].parent is None
    assert spans["piece", 0].parent == spans["root", None].id
    assert spans["other", None].request != spans["root", None].request
