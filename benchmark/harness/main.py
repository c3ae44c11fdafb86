"""One run of one cell of the port's benchmark:

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up builds the pipeline from the cell's configuration with weights
made on the card from the seed, and warms up the shapes of the cell's
traffic (``setup_s`` runs from the process's start to the first timed
request).  Then one client sends requests back to back for ``--seconds``
(a closed loop); every request started in the window runs to its end.
With ``--trace 1`` the requests go stage by stage, each stage a span
closed by a synchronize, and ``torch.profiler`` records a few requests of
the cell's own path.  After the window: the device's memory peak is read,
the program is freed, and a sample of the window's requests, drawn from
the seed over the whole window, is held against the plain reference
(``reference.py``); each number compared is printed beside its limit.  A
run in which any request failed is not correct.  The last line of standard
output is the result, as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import resource
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import seeded
from .spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "float_tpu")
MAX_FAILURES_IN_A_ROW = 3


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``float_torch`` is not ``float_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Request:
    """One request of the window: when it started and ended on the host
    clock, what it delivered, and whatever its driver notes."""

    def __init__(self, index: int, params: dict):
        self.index = index
        self.params = params
        self.t0 = self.t1 = None
        self.frames = 0
        self.ttfc = None
        self.chunks = 0
        self.failed = False


class Run:
    """What one run knows; the drivers and the metric readers read it."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool,
                 device):
        import torch
        self.torch = torch
        self.cell = cell
        self.model = cell.model
        self.mix = cell.mix
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.device = torch.device(device)
        self.pipe = None
        self.requests: list = []
        self.spans: list = []               # (name, request, t0, t1)
        self.trace = None
        self.setup_s = None
        self.window_t0 = None
        self.memory_peak = None
        self.sample = Sample(seed, 0)
        self._ref_params = None

    # -- the clock --------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, index: int):
        """A host-clock span of a stage, closed by a synchronize."""
        t0 = time.perf_counter()
        yield
        self.sync()
        self.spans.append((name, index, t0, time.perf_counter()))

    # -- the program ------------------------------------------------------
    def configs(self):
        from float_torch.config import FloatConfig, Wav2Vec2Config

        def w2v(d):
            return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in d.items()})
        return (FloatConfig(**self.model["float"]).validate(),
                w2v(self.model["wav2vec2"]), w2v(self.model["ser"]))

    def weights(self) -> dict:
        from float_torch.models.init import init_pipeline
        return seeded.weight_tree(init_pipeline, self.configs(), self.seed,
                                  self.device)

    def build(self) -> None:
        from float_torch.models.init import ParamTree
        from float_torch.runtime.pipeline import FloatPipeline
        cfg, w2v, ser = self.configs()
        tree = ParamTree(self.weights())
        self.pipe = FloatPipeline(tree, cfg, w2v, ser, device=self.device)
        del tree
        self.release()

    def release(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the sample held against the reference ----------------------------
    def keeps(self, index: int) -> bool:
        return self.sample.holds(index)

    def keep(self, index: int, payload) -> None:
        """The output of a request, kept where the request is sampled."""
        self.sample.keep(index, payload)

    def compared(self) -> list:
        """[(request, payload)] of the sampled requests that ran."""
        done = {r.index: r for r in self.requests if not r.failed}
        return [(done[i], p) for i, p in sorted(self.sample.kept.items())
                if i in done]

    def ref_params(self) -> dict:
        """The reference's weights: the seed's, made again."""
        if self._ref_params is None:
            self._ref_params = self.weights()
        return self._ref_params


def judge(run: Run, driver, prec) -> dict:
    """Each number of the driver's comparison, the largest over the
    compared requests; ``prec`` the reference's precision."""
    per = [driver.numbers(run, req, payload,
                          driver.expected(run, req, prec))
           for req, payload in run.compared()]
    return {k: max(p[k] for p in per) for k in per[0]} if per else {}


class Sample:
    """The window's requests that are held against the reference:
    ``count`` drawn uniformly from however many the window completes
    (reservoir sampling, Algorithm R, its draws from the seed), and, where
    the driver marks some requests as the longest, one of those drawn
    alike.  Requests are offered in the order they are sent; only the
    outputs of those that hold a slot are kept, so a run holds at most
    ``count`` + 1 requests' outputs."""

    def __init__(self, seed: int, count: int, longest=None):
        self.rng = np.random.default_rng(seeded.sub_seed(seed, 7))
        self.count = count
        self.longest = longest
        self.offered = self.offered_longest = 0
        self.slots: dict = {}              # slot -> request index
        self.kept: dict = {}               # request index -> output

    def offer(self, index: int) -> None:
        j = self.offered if self.offered < self.count else int(
            self.rng.integers(self.offered + 1))
        self.offered += 1
        if j < self.count:
            self.slots[j] = index
        if self.longest is not None and self.longest(index):
            if int(self.rng.integers(self.offered_longest + 1)) == 0:
                self.slots["longest"] = index
            self.offered_longest += 1
        held = set(self.slots.values())
        for i in [i for i in self.kept if i not in held]:
            del self.kept[i]

    def holds(self, index: int) -> bool:
        return index in self.slots.values()

    def keep(self, index: int, payload) -> None:
        if self.holds(index):
            self.kept[index] = payload

    def indices(self) -> list:
        return sorted(set(self.slots.values()))


def sample_for(run, driver) -> Sample:
    longest = getattr(driver, "longest", None)
    return Sample(run.seed, int(run.mix["check"]["requests"]),
                  None if longest is None else
                  (lambda index: longest(run, index)))


def host_reading() -> dict:
    """This process's CPU seconds, and how fast the host runs a fixed
    piece of work: a Python loop (the thread that launches the program's
    kernels) and a 64 MiB copy (the host's numpy work)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    x = 0
    for i in range(200_000):
        x += i
    t1 = time.perf_counter()
    a = np.ones(1 << 24, np.float32)
    t2 = time.perf_counter()
    a.copy()
    t3 = time.perf_counter()
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "loop_ms": 1e3 * (t1 - t0),
            "copy_gb_s": a.nbytes / (t3 - t2) / 1e9}


def card_reading(device, fields: str) -> str | None:
    """``nvidia-smi``'s reading of ``fields`` on the run's card (None off
    the card, or where it cannot read)."""
    if device.type != "cuda":
        return None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# the card's SM clock, temperature, power draw and active throttle reasons
CARD_STATE = ("clocks.sm,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")


def host_line(before: dict, after: dict, wall: float) -> str:
    """The host over ``wall`` seconds: this process's CPU seconds a wall
    second, and the fixed work's times before and after."""
    return (f"process cpu {(after['cpu_s'] - before['cpu_s']) / wall:.4f} "
            f"s/s; python loop {before['loop_ms']:.3f} -> "
            f"{after['loop_ms']:.3f} ms; copy {before['copy_gb_s']:.3f} -> "
            f"{after['copy_gb_s']:.3f} GB/s; {os.cpu_count()} cpus")


def drive(run: Run, driver) -> None:
    """The closed loop: requests back to back until ``seconds`` have
    passed since the first; the traced run profiles requests 1 to
    ``profile_requests`` of the driver's own path."""
    from .trace import Profiled
    n_prof = int(run.mix.get("profile_requests", 1))
    prof = None
    failures = 0
    requests = driver.requests(run)
    card = card_reading(run.device, CARD_STATE)
    run.sync()
    host = host_reading()
    run.window_t0 = t_start = time.perf_counter()
    while time.perf_counter() - t_start < run.seconds:
        req = next(requests)
        run.sample.offer(req.index)
        profiled = run.traced and 1 <= req.index <= n_prof
        if profiled and prof is None:
            from float_torch.kernels import LAUNCH_SHAPES
            prof = Profiled(run.device, LAUNCH_SHAPES)
            prof.start()
        try:
            driver.serve(run, req, staged=run.traced and not profiled)
            failures = 0
        except Exception:                  # noqa: BLE001 - counted, shown
            req.failed = True
            failures += 1
            traceback.print_exc(file=sys.stderr)
        run.requests.append(req)
        if prof is not None and req.index == n_prof:
            t_red = time.perf_counter()
            run.trace = prof.stop()
            prof = None
            print(f"[trace] read in {time.perf_counter() - t_red:.3f} s",
                  file=sys.stderr)
        if failures >= MAX_FAILURES_IN_A_ROW:
            break
    wall = time.perf_counter() - t_start
    print(f"[host] window {wall:.3f} s: {host_line(host, host_reading(), wall)}",
          file=sys.stderr)
    print(f"[card] before the window: {card}; after: "
          f"{card_reading(run.device, CARD_STATE)}", file=sys.stderr)
    if prof is not None:
        run.trace = prof.stop()


def device_info(run: Run) -> dict:
    torch = run.torch
    info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(run.device)
                     if run.device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": run.memory_peak}
    info["power_limit"] = card_reading(run.device, "power.limit")
    if run.trace is not None and run.trace["busy_s"] > 0:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def read_metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="benchmark/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: Path, t_process: float, device=None) -> int:
    """Run one cell; 0 when a result line was printed.  ``device`` None
    looks for the card the cell needs; a test passes "cpu" to drive the
    rest of a run there."""
    args = parse(argv)
    cell = Cell(root, args.workload)
    if device is None:
        import torch
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
                  f"device(s); found {found}", file=sys.stderr)
            return 2
        device = "cuda:0"
    try:
        import float_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the program under test is missing ({exc})",
              file=sys.stderr)
        return 2
    driver = cell.driver()
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device)
    run.sample = sample_for(run, driver)

    t_build = time.perf_counter()
    run.build()
    run.sync()
    t_warm = time.perf_counter()
    driver.warm(run)
    run.sync()
    t_end = time.perf_counter()
    run.setup_s = t_end - t_process
    print(f"[setup] {run.setup_s:.3f} s: imports "
          f"{t_build - t_process:.3f}, CUDA context, weights and pipeline "
          f"{t_warm - t_build:.3f}, warm-up {t_end - t_warm:.3f}",
          file=sys.stderr, flush=True)

    drive(run, driver)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the port "
              "must not", file=sys.stderr)
        return 3
    if run.device.type == "cuda":
        run.memory_peak = run.torch.cuda.max_memory_allocated(run.device)
    metrics = read_metrics(run, cell.per_layer if run.traced
                           else cell.end_to_end)
    info = device_info(run)

    run.pipe = None
    run.release()
    from .reference import F32
    t_ref = time.perf_counter()
    numbers = judge(run, driver, F32)
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    attempted = len(run.requests)
    failed = sum(r.failed for r in run.requests)
    correct = not failed and bool(numbers) and set(numbers) == set(
        cell.limits) and all(math.isfinite(v) and v <= cell.limits[k]
                             for k, v in numbers.items())
    # a gap that is not a number is written as null: the line stays JSON
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": cell.limits[k]} for k, v in numbers.items()}
    secs = sorted(r.t1 - r.t0 for r in run.requests if not r.failed)
    if secs:
        print(f"[requests] s: min {secs[0]:.4f} median "
              f"{secs[(len(secs) - 1) // 2]:.4f} max {secs[-1]:.4f}",
              file=sys.stderr)
    print(f"[window] {attempted} requests, {failed} failed, "
          f"{sum(r.frames for r in run.requests)} frames; compared "
          f"{[r.index for r, _ in run.compared()]}", file=sys.stderr)
    if run.trace is not None:
        print(f"[trace] busy {run.trace['busy_s']:.4f} s of "
              f"{run.trace['window_s']:.4f} s; power limit "
              f"{info['power_limit']}", file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
