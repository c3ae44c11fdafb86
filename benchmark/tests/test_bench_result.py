"""The result line and the guards of a run, on the CPU at a tiny size:
its keys, the comparison's numbers last, no JAX, no card, no program."""
import os
import subprocess
import sys
import types

import pytest

import tiny
from harness.main import FORBIDDEN, forbidden_modules


def test_forbidden_names_compare_whole_top_levels():
    mods = {"float_torch": 1, "float_torch.models": 1, "float_tpu_x": 1,
            "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(mods) == []
    for name in FORBIDDEN:
        assert forbidden_modules({f"{name}.sub": 1}) == [name]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny_root, capsys, trace):
    code, result, err = tiny.run(tiny_root, "ser-stream-utter", capsys,
                                 trace=trace)
    assert code == 0
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        # no device metric from a CPU run
        assert set(result["metrics"]) <= {"encode_ms.stream",
                                          "sample_ms_per_chunk.stream"}
        assert "busy_s" not in dev
    else:
        assert set(result["metrics"]) == {"stream_frames_per_s",
                                          "ttfc_p90_s",
                                          "setup_s"}
    tail = err.strip().splitlines()[-len(result["checks"]):]
    for line, (name, c) in zip(tail, result["checks"].items()):
        assert line == f"[check] {name} {c['value']!r} limit {c['limit']!r}"


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, capsys,
                                                 monkeypatch):
    monkeypatch.setitem(sys.modules, "float_tpu", types.ModuleType("x"))
    code, result, err = tiny.run(tiny_root, "ser-clip10s", capsys)
    assert code == 3 and result is None and "float_tpu" in err


def test_no_card_no_result(tmp_path):
    """run.py in a directory holding BENCHMARK.json and benchmark/ alone,
    with no card visible."""
    tiny.make_root(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ser-clip10s", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_program_no_result(tmp_path, monkeypatch):
    from harness.main import main
    tiny.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "float_torch", None)
    assert main(["--workload", "ser-clip10s", "--seed", "1", "--seconds",
                 "1"], tmp_path, 0.0, device="cpu") == 2



def test_a_failed_request_makes_the_run_not_correct(tiny_root, capsys,
                                                     monkeypatch):
    from float_torch.runtime.pipeline import FloatPipeline
    real = FloatPipeline.generate
    calls = []

    def fails_after_warm_up(self, *a, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted failure")
        return real(self, *a, **kw)
    monkeypatch.setattr(FloatPipeline, "generate", fails_after_warm_up)
    code, result, _err = tiny.run(tiny_root, "ser-clip10s", capsys)
    assert code == 0 and result["failed"] >= 1
    assert result["correct"] is False


def test_a_failed_stream_counts_as_never_reaching_its_first_chunk():
    import importlib.util
    from types import SimpleNamespace
    spec = importlib.util.spec_from_file_location(
        "ttfc", tiny.BENCH / "metrics" / "ttfc_p90_s.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(failed):
        reqs = [SimpleNamespace(failed=False, ttfc=0.1 * (i + 1))
                for i in range(10)]
        reqs += [SimpleNamespace(failed=True, ttfc=None)] * failed
        return SimpleNamespace(requests=reqs)
    assert mod.read(run(0)) == pytest.approx(0.9)
    assert mod.read(run(1)) == pytest.approx(1.0)
    assert mod.read(run(2)) is None
