"""The reader of ``merge_roofline.clip``: K8's bytes bound, counted from
its launch shapes, over its device time by kernel name, equal to
``chip_smoke.k8_bound`` at config 1's shapes; no reading without a trace,
without K8's launches or without its kernel time (a program without
K8)."""
from types import SimpleNamespace

import pytest

import tiny
from harness import yardstick
from harness.spec import load_module

METRIC = load_module(tiny.BENCH / "metrics" / "merge_roofline.clip.py",
                     "metric")
KERNEL = ("void (anonymous namespace)::flow_merge_kernel<__nv_bfloat16, "
          "warp::Vec<__nv_bfloat16> >(...)")
LEVELS = ((8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64),
          (512, 32))


def _chunk_shapes(b=24, n=1):
    """``n`` chunks' launches of a 512² decode: 6 merges, the last level."""
    shapes = {("flow_merge", b, s, s, c): n for s, c in LEVELS[:-1]}
    shapes[("flow_merge_last", b, 512, 512, 32)] = n
    return shapes


def _run(shapes, kernel_s, dtype="bfloat16"):
    trace = None if shapes is None else {
        "launch_shapes": {**shapes, ("warp_shared", 24, 8, 8, 512): 1},
        "kernel_s": kernel_s}
    return SimpleNamespace(trace=trace,
                           model={"float": {"compute_dtype": dtype}})


@pytest.mark.parametrize("mode,size,c", [("merge", 8, 512),
                                         ("merge", 256, 64),
                                         ("last", 512, 32)])
def test_bound_is_chip_smokes(mode, size, c):
    import chip_smoke
    ms, _by = chip_smoke.k8_bound(mode, size, c, 24, 2)
    merged = mode == "merge"
    ops = 24 * size * size * (c * METRIC.OPS_PER_ELEMENT[merged]
                              + METRIC.OPS_PER_PIXEL)
    assert yardstick.bound_s(METRIC.merge_bytes(merged, 24, size, size, c, 2),
                             ops) == pytest.approx(ms / 1e3, rel=1e-12)


def test_the_share_of_the_bound():
    """11 chunks' launches over their kernel time; other kernels' time
    and launches are not counted."""
    shapes = _chunk_shapes(n=11)
    bound = sum(n * yardstick.bound_s(
        METRIC.merge_bytes(name == "flow_merge", b, h, w, c, 2),
        b * h * w * (c * METRIC.OPS_PER_ELEMENT[name == "flow_merge"]
                     + METRIC.OPS_PER_PIXEL))
        for (name, b, h, w, c), n in shapes.items())
    got = METRIC.read(_run(shapes, {KERNEL: 2 * bound,
                                    "void staged_kernel<bf16, 2>": 1.0}))
    assert got == pytest.approx(50.0)
    # a chunk's bound: 0.48 ms at 512² alone (1.61 GB at 3.35 TB/s)
    assert bound / 11 > 0.48e-3


@pytest.mark.parametrize("run", [
    _run(None, {}), _run({}, {KERNEL: 1e-3}), _run(_chunk_shapes(), {}),
    _run(_chunk_shapes(), {"void staged_kernel<bf16, 2>": 1e-3})],
    ids=["no trace", "no launches", "no kernel time", "another kernel"])
def test_no_reading(run):
    assert METRIC.read(run) is None
