"""The serving daemon under load on one CUDA card (twin of
tools/serve_load_bench.py).

Starts ``float_torch.serve``'s HTTP daemon in this process on config 1
(the bench's pipeline: ``FLOAT_CKPT`` when that file exists, else
synthetic weights; ``FLOAT_DECODE_BATCH``, default 24), drives it with
``float_torch.client.FloatClient`` threads and prints one JSON line, then
a markdown table:

    python -m float_torch.tools.serve_load_bench [--clip-sec 4] [--reqs 3]
        [--port 0] [--overload] [--soak-sec N] [--max-pending 4]
        [--stall-sec 20]

Lanes:
- base: two clients at once, one of ``--reqs`` mp4 one-shots and one of
  ``--reqs`` NDJSON streams (``first_chunk`` 8): request latency and
  lock-wait percentiles from ``/metrics``, frames per device-busy second,
  the streams' time to the first chunk at the client;
- delivered frames/s, raw against ``"encoding": "jpeg"`` streams, one
  client, best of 2, with the wire KB a frame;
- ``--overload``: ``max_pending`` + 3 mp4 clients fired at once (real
  503s with ``Retry-After``) while one stream reader reads one line and
  stalls (its generation must be aborted after ``--stall-sec`` and free
  the lock), then one probe request that must succeed;
- ``--soak-sec N``: N seconds of mp4, stream and JPEG traffic at once:
  requests, errors, 503s and the process's RSS at the start and end.

Every HTTP call, thread join and wait has a timeout: a request that hangs
becomes an error in the line, not a hang.  The clients are threads of
this process (as in tools/serve_load_bench.py), so they share the
server's interpreter lock: delivered frames/s is a lower bound on what a
client process of its own would see.  Without a card nothing is
measured (exit 1); ``run_load`` takes any FloatPipe, a CPU one in the
tests.
"""
from __future__ import annotations

import argparse
import http.client
import json
import statistics
import sys
import threading
import time
import urllib.request

import numpy as np

REQUEST_TIMEOUT_S = 300.0


def _rss_mb() -> float:
    """This process's resident set now (Linux /proc), else its peak."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os
        return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20
    except (OSError, ValueError, IndexError):
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _med(xs):
    return statistics.median(xs) if xs else None


def _join(threads, timeout: float, errs: list, what: str) -> None:
    """Join every thread by one deadline; a thread still running then is
    recorded as an error (it is a daemon and dies with the process)."""
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            errs.append(f"{what}: {t.name} still running after {timeout} s")


def _settled(cli, n: int, wait: float = 10.0) -> dict:
    """/metrics once the server has recorded n request latencies (a
    handler records its request after the client has read the body), or
    after ``wait`` seconds."""
    deadline = time.monotonic() + wait
    m = cli.metrics()
    while (m["latency_seconds"] or {}).get("count", 0) < n \
            and time.monotonic() < deadline:
        time.sleep(0.05)
        m = cli.metrics()
    return m


def _thread(fn, *args) -> threading.Thread:
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


def base_lane(url, img, audio, reqs: int, timeout: float) -> dict:
    """One mp4 client and one stream client, ``reqs`` requests each, at
    the same time."""
    from ..client import FloatClient
    res = {"mp4": [], "stream": [], "ttfc": []}
    errs: list = []

    def one_shot():
        c = FloatClient(url, timeout=timeout)
        for i in range(reqs):
            t0 = time.perf_counter()
            try:
                if not c.generate(img, audio, seed=20 + i):
                    raise RuntimeError("empty mp4")
                res["mp4"].append(time.perf_counter() - t0)
            except Exception as e:      # noqa: BLE001 (recorded, reported)
                errs.append(f"mp4[{i}]: {e!r}")

    def streams():
        c = FloatClient(url, timeout=timeout)
        for i in range(reqs):
            t0 = time.perf_counter()
            try:
                first = None
                for _start, _frames in c.stream(img, audio, seed=40 + i,
                                                first_chunk=8):
                    first = first or time.perf_counter() - t0
                res["stream"].append(time.perf_counter() - t0)
                res["ttfc"].append(first)
            except Exception as e:      # noqa: BLE001
                errs.append(f"stream[{i}]: {e!r}")

    t0 = time.perf_counter()
    _join([_thread(one_shot), _thread(streams)], 2 * reqs * timeout, errs,
          "base lane")
    return {"wall_s": time.perf_counter() - t0, "errors": errs,
            "client_med_mp4_s": _med(res["mp4"]),
            "client_med_stream_s": _med(res["stream"]),
            "client_med_ttfc_s": _med(res["ttfc"])}


def delivered_lane(url, img, audio, timeout: float) -> dict:
    """Raw against JPEG streams, one client, best of 2; wire KB a frame
    (the raw lines' size is counted, the JPEG lines' read)."""
    from ..client import FloatClient, _b64
    c = FloatClient(url, timeout=timeout)
    out = {}
    for enc in ("raw", "jpeg"):
        kw = {} if enc == "raw" else {"encoding": "jpeg", "quality": 85}
        best = None
        for rep in range(2):
            t0 = time.perf_counter()
            nf = sum(f.shape[0] for _s, f in c.stream(
                img, audio, seed=77 + rep, first_chunk=8, **kw))
            dt = time.perf_counter() - t0
            best = min(best or (dt, nf), (dt, nf))
        out[enc] = {"frames": best[1], "wall_s": best[0],
                    "delivered_fps": best[1] / best[0]}
    body = json.dumps({"image": _b64(img), "audio": _b64(audio),
                       "stream": True, "seed": 78, "encoding": "jpeg",
                       "quality": 85, "first_chunk": 8}).encode()
    rq = urllib.request.Request(url + "/v1/generate", data=body,
                                headers={"Content-Type": "application/json"})
    jpeg_bytes = raw_est = 0
    with urllib.request.urlopen(rq, timeout=timeout) as r:
        for line in r:
            jpeg_bytes += len(line)
            raw_est += int(np.prod(json.loads(line)["shape"]) * 4 / 3) + 120
    nfr = out["jpeg"]["frames"]
    out["jpeg"]["wire_kb_per_frame"] = jpeg_bytes / nfr / 1024
    out["raw"]["wire_kb_per_frame"] = raw_est / nfr / 1024
    return out


def overload_lane(url, port: int, img, audio, max_pending: int,
                  stall_sec: float, timeout: float) -> dict:
    """``max_pending`` + 3 mp4 clients at once beside one stalled stream
    reader; then a probe request."""
    from ..client import FloatClient, _b64
    cli = FloatClient(url, timeout=timeout)
    base = cli.metrics()
    codes, lock, errs = [], threading.Lock(), []

    def burst(i):
        try:
            blob = FloatClient(url, timeout=timeout).generate(
                img, audio, seed=300 + i)
            tag = ("ok", len(blob))
        except Exception as e:          # noqa: BLE001
            code = getattr(e, "code", None)
            retry = getattr(e, "headers", {}) or {}
            tag = ((f"http{code}", retry.get("Retry-After")) if code
                   else ("err", repr(e)))
        with lock:
            codes.append(tag)

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"image": _b64(img), "audio": _b64(audio), "stream": True,
             "seed": 299}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.readline()                  # one line, then nothing
        t0 = time.perf_counter()
        _join([_thread(burst, i) for i in range(max_pending + 3)],
              timeout, errs, "overload burst")
        deadline = time.monotonic() + stall_sec + timeout
        while (cli.metrics()["stream_aborts"] <= base["stream_aborts"]
               and time.monotonic() < deadline):
            time.sleep(0.2)
        aborted_after = time.perf_counter() - t0
    finally:
        conn.close()
    m = cli.metrics()
    probe = cli.generate(img, audio, seed=999)
    rej = [c for c in codes if c[0] == "http503"]
    return {
        "burst_clients": max_pending + 3, "max_pending": max_pending,
        "ok": sum(c[0] == "ok" for c in codes), "rejected_503": len(rej),
        "retry_after": sorted({c[1] for c in rej}, key=str),
        "other_errors": [c for c in codes if c[0] not in ("ok", "http503")]
        + errs,
        "stream_aborts_delta": m["stream_aborts"] - base["stream_aborts"],
        "stall_sec": stall_sec, "aborted_within_s": aborted_after,
        "post_overload_probe_ok": len(probe) > 1000}


def soak_lane(url, img, audio, seconds: float, frames_per_clip: int,
              timeout: float) -> dict:
    """``seconds`` of mp4, raw-stream and JPEG-stream clients at once."""
    from ..client import FloatClient
    cli = FloatClient(url, timeout=timeout)
    rss0, base = _rss_mb(), cli.metrics()
    stop = time.monotonic() + seconds
    errs: list = []
    counts = {"mp4": 0, "stream": 0, "jpeg": 0}

    def lane(kind):
        c = FloatClient(url, timeout=timeout)
        i = 0
        while time.monotonic() < stop:
            i += 1
            try:
                if kind == "mp4":
                    if len(c.generate(img, audio, seed=1000 + i)) <= 1000:
                        raise RuntimeError("short mp4")
                else:
                    kw = {"encoding": "jpeg"} if kind == "jpeg" else {}
                    nf = sum(f.shape[0] for _s, f in c.stream(
                        img, audio, seed=2000 + i, **kw))
                    if nf != frames_per_clip:
                        raise RuntimeError(f"{nf} frames")
                counts[kind] += 1
            except Exception as e:      # noqa: BLE001
                if getattr(e, "code", None) == 503:
                    time.sleep(1.0)     # back off as Retry-After asks
                else:
                    errs.append(f"{kind}[{i}]: {e!r}")

    t0 = time.perf_counter()
    _join([_thread(lane, k) for k in counts], seconds + timeout, errs,
          "soak")
    m = cli.metrics()
    return {"seconds": time.perf_counter() - t0, "completed": counts,
            "frames": m["frames"] - base["frames"], "errors": errs[:10],
            "error_count": len(errs),
            "rejected_503": m["rejected_busy"] - base["rejected_busy"],
            "rss_start_mb": rss0, "rss_end_mb": _rss_mb()}


def run_load(fpipe, clip_sec: float = 4.0, reqs: int = 3, port: int = 0,
             overload: bool = False, soak_sec: float = 0.0,
             max_pending: int = 4, stall_sec: float = 20.0,
             timeout: float = REQUEST_TIMEOUT_S) -> dict:
    """The lanes against a server on 127.0.0.1 around ``fpipe`` (a loaded
    FloatPipe); the JSON line as a dict.  ``timeout`` bounds each HTTP
    call, and with the lane's request count each join."""
    from ..client import FloatClient
    from ..runtime.pipeline import audio_num_frames
    from ..serve import make_server
    cfg = fpipe.cfg
    # a small stream buffer, so the overload lane's stalled reader fills it
    httpd = make_server(fpipe, port=port, max_pending=max_pending,
                        stream_buffer_mb=48, stream_stall_timeout=stall_sec)
    port = httpd.server_address[1]
    url = f"http://127.0.0.1:{port}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        rng = np.random.default_rng(0)
        img = (rng.random((cfg.input_size, cfg.input_size, 3)) * 255
               ).astype(np.uint8)
        audio = (rng.standard_normal(int(clip_sec * cfg.sampling_rate))
                 * 0.1).astype(np.float32)
        cli = FloatClient(url, timeout=timeout)
        health = cli.health()
        # warm: kernel builds and cuDNN's choices for every served shape
        t0 = time.perf_counter()
        cli.generate(img, audio, seed=100)
        for enc in ("raw", "jpeg"):
            for _part in cli.stream(img, audio, seed=200, first_chunk=8,
                                    encoding=enc):
                pass
        warm_s = time.perf_counter() - t0
        _settled(cli, 3)                 # the warm requests all recorded
        srv = httpd.RequestHandlerClass.srv
        srv.latency.reset()
        srv.lock_wait.reset()
        base = cli.metrics()
        lane = base_lane(url, img, audio, reqs, timeout)
        m = _settled(cli, 2 * reqs)
        frames = m["frames"] - base["frames"]
        busy = m["busy_seconds"] - base["busy_seconds"]
        out = {"metric": "serve_2client_load", "clip_sec": clip_sec,
               "requests": 2 * reqs, **lane, "frames": frames,
               "busy_seconds": busy,
               "frames_per_busy_second": frames / busy if busy else None,
               "latency_seconds": m["latency_seconds"],
               "lock_wait_seconds": m["lock_wait_seconds"],
               "rejected_busy": m["rejected_busy"], "warm_s": warm_s,
               "device": health["device"],
               "device_name": health["device_name"],
               "weights": health["weights"]}
        out["delivered"] = delivered_lane(url, img, audio, timeout)
        out["overload"] = (overload_lane(url, port, img, audio, max_pending,
                                         stall_sec, timeout)
                           if overload else None)
        frames_per_clip = audio_num_frames(audio.shape[0], cfg)
        out["soak"] = (soak_lane(url, img, audio, soak_sec, frames_per_clip,
                                 timeout) if soak_sec > 0 else None)
        return out
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(30)


def table(out: dict, reqs: int) -> str:
    lat, lw = out["latency_seconds"] or {}, out["lock_wait_seconds"] or {}
    d = out["delivered"]
    rows = [
        "| quantity | value |", "|---|---|",
        f"| requests (2 clients × {reqs}, {out['clip_sec']:g} s clips) | "
        f"{out['requests']} sent, {len(out['errors'])} errors |",
        f"| wall for the whole load | {out['wall_s']:.1f} s |",
        f"| frames / device-busy second | "
        f"{out['frames_per_busy_second'] or 0:.1f} |",
        f"| request latency p50 / p95 / p99 | {lat.get('p50')} / "
        f"{lat.get('p95')} / {lat.get('p99')} s |",
        f"| lock-wait p50 / p95 / p99 | {lw.get('p50')} / {lw.get('p95')} / "
        f"{lw.get('p99')} s |",
        f"| stream time to first chunk (client, median) | "
        f"{out['client_med_ttfc_s'] or 0:.3f} s |",
        f"| delivered frames/s raw / jpeg | {d['raw']['delivered_fps']:.1f}"
        f" / {d['jpeg']['delivered_fps']:.1f} |",
        f"| wire KB a frame raw / jpeg | {d['raw']['wire_kb_per_frame']:.1f}"
        f" / {d['jpeg']['wire_kb_per_frame']:.1f} |"]
    if out["overload"]:
        o = out["overload"]
        rows.append(
            f"| overload: {o['burst_clients']} clients vs max_pending "
            f"{o['max_pending']} | {o['ok']} ok, {o['rejected_503']} × 503, "
            f"aborts {o['stream_aborts_delta']}, probe "
            f"{'ok' if o['post_overload_probe_ok'] else 'FAILED'} |")
    if out["soak"]:
        s = out["soak"]
        rows.append(
            f"| soak {s['seconds']:.1f} s | {s['completed']} completed, "
            f"{s['error_count']} errors, {s['rejected_503']} × 503, RSS "
            f"{s['rss_start_mb']:.0f} -> {s['rss_end_mb']:.0f} MB |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip-sec", type=float, default=4.0)
    ap.add_argument("--reqs", type=int, default=3,
                    help="requests per client of the base lane")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--overload", action="store_true")
    ap.add_argument("--soak-sec", type=float, default=0.0)
    ap.add_argument("--max-pending", type=int, default=4)
    ap.add_argument("--stall-sec", type=float, default=20.0,
                    help="the server's stream stall timeout")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_load_bench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    from ..api.types import FloatPipe
    from ..bench import config1, load_pipeline
    cfg = config1()
    pipe, weights = load_pipeline(cfg)
    out = run_load(FloatPipe(pipe, cfg, weights=weights),
                   clip_sec=args.clip_sec, reqs=args.reqs, port=args.port,
                   overload=args.overload, soak_sec=args.soak_sec,
                   max_pending=args.max_pending, stall_sec=args.stall_sec)
    print(json.dumps(out))
    print(table(out, args.reqs))
    bad = out["errors"] or (out["soak"] or {}).get("error_count")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
