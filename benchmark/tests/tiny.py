"""A checkout of the benchmark at a tiny size, for the CPU tests: the
repository's BENCHMARK.json and benchmark/ data, the configurations cut to
the widths of the port's CPU tests and the mixes to short requests.  Its
BENCHMARK.json also holds the entries of the cells parked under
benchmark/parked/, so their files stay tested."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
PARKED = BENCH / "parked"
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

FLOAT = dict(input_size=64, dim_w=64, dim_a=64, dim_h=64, dim_m=20,
             dim_e=7, fmt_depth=2, num_heads=4, wav2vec_sec=0.4,
             num_prev_frames=3, decode_batch=4, compute_dtype="float32")
W2V = dict(conv_dim=[16, 16, 16], conv_kernel=[10, 3, 3],
           conv_stride=[5, 2, 2], hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
# The tiny decode runs in float32, so its frames match the reference's to
# rounding: the sound runs read at most 3.2e-7 on these numbers, the
# faults of harness/faults.py 7.2e-4 or more (CPU, float32).
LIMITS = {"frame_mae_max": 1e-4, "scene_mae_max": 1e-4}
MIXES = {"clip10s": {"seconds": 1},
         "scene10s": {"seconds": 1},
         "stream_utter": {"lengths_s": [1, 2], "check": {"requests": 1,
                                                         "window": 2}}}


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


def parked() -> dict:
    """{group: entries} that the parked cells would add to BENCHMARK.json
    (each file of benchmark/parked/ holds a cell's entries by group)."""
    out: dict = {}
    for path in sorted(PARKED.glob("*.json")):
        for group, entries in json.loads(path.read_text()).items():
            out.setdefault(group, []).extend(entries)
    return out


def kind(workload: str) -> str:
    """The traffic kind of a cell, read from its files."""
    w = json.loads((BENCH / "workloads" / f"{workload}.json").read_text())
    return json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                      .read_text())["kind"]


def make_root(dst: Path, cut: bool = True) -> Path:
    """Copy BENCHMARK.json, with the parked cells' entries added, and
    benchmark/ to ``dst``; cut to tiny unless ``cut`` is false."""
    dst = Path(dst)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for group, entries in parked().items():
        spec[group].extend(entries)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if not cut:
        return dst
    for cfg in (dst / "benchmark" / "configs").glob("*.json"):
        def shrink(c):
            c["float"].update(FLOAT)
            c["wav2vec2"].update(W2V)
            c["ser"].update(W2V)
        _edit(cfg, shrink)
    for cell in (dst / "benchmark" / "workloads").glob("*.json"):
        _edit(cell, lambda w: w["limits"].update(
            {k: v for k, v in LIMITS.items() if k in w["limits"]}))
    for mix, change in MIXES.items():
        _edit(dst / "benchmark" / "traffic" / f"{mix}.json",
              lambda m, change=change: m.update(change))
    return dst


def run(root: Path, workload: str, capsys, seed: int = 2 ** 31 + 11,
        seconds: float = 0.1, trace: int = 0) -> tuple:
    """(exit code, result or None, stderr) of one run on the CPU: the
    harness without its look for a card."""
    import time

    from harness.main import main
    code = main(["--workload", workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(trace)], Path(root),
                time.perf_counter(), device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return code, json.loads(lines[-1]) if lines else None, err
