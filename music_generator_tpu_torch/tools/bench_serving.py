"""End-to-end HTTP serving benchmark of the port: the service measured over
a real socket (the JAX package's `tools/bench_serving.py`).

Starts `GenerationService` (the object `serve.py` runs) in-process behind
a real `DeepJHTTPServer` on 127.0.0.1, then measures wall-clock
request -> response latency for the serving workloads:

  solo     - POST /generate, 1 piece x `--bars` bars (interactive request)
  batch16  - POST /generate_batch, 16 mixtures in ONE device call
  primed   - POST /generate with a `--bars`-bar prime_midi + `--bars` new
             bars (continuation only)
  concurrent16 - 16 simultaneous solo /generate requests with distinct
             (genre, seed): the coalescing workload; wall clock for all 16
             and the device calls of each rep (coalescing shows as fewer
             than 16)
  mixed_bars - 1-bar requests timed on a quiet service, then WHILE two
             threads keep requests of 8 x `--bars` bars in flight (the
             time-sliced scheduler), then with the bars grouping disabled
             so the short request rides the long jobs (early completion)
  overload - 12 concurrent requests past max_pending=2: 503 sheds vs 200s

Every workload reports its reps in order (`reps_ms`), median and minimum.
The JSON starts with the card's name and power limit; `--out` names the
file it writes.

    python -m music_generator_tpu_torch.tools.bench_serving \
        [--reps 10] [--device cpu] [--out runs/serving_bench_torch.json]
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import threading
import time
import urllib.error
import urllib.request

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.device import resolve_device
from music_generator_tpu_torch.params import load_params_npz
from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                               GenerationService,
                                               make_handler)
from music_generator_tpu_torch.tools.common import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _post(url: str, path: str, payload: dict) -> bytes:
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _timed_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _pct(xs, q: float) -> float:
    o = sorted(xs)
    return o[min(len(o) - 1, int(round(q * (len(o) - 1))))]


def _summary(times, pieces: int, steps: int) -> dict:
    median = _pct(times, 0.5)
    return {"reps_ms": times, "median_ms": median, "min_ms": min(times),
            "median_ms_per_piece": median / pieces,
            "median_ms_per_timestep": median / (pieces * steps)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--bars", type=int, default=8)
    parser.add_argument("--params", default=os.path.join(
        REPO, "artifacts", "trained_model_r4", "params.npz"))
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; a missing card is an error) "
                             "or cpu")
    parser.add_argument("--out", default=os.path.join(
        REPO, "runs", "serving_bench_torch.json"))
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = default_config()
    started = time.perf_counter()
    # Every bucket a coalesced drain of concurrent16 can land on.
    service = GenerationService(config=cfg,
                                params=load_params_npz(args.params),
                                device=device, warmup_buckets=16)
    startup_s = time.perf_counter() - started
    httpd = DeepJHTTPServer(("127.0.0.1", 0), make_handler(service))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        results = _run(service, url, args, cfg)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    results = {"card": card_line() if device.type == "cuda" else "cpu",
               "device": str(device), "startup_s": startup_s,
               "params": os.path.relpath(args.params, REPO), **results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", args.out, flush=True)
    return results


def _run(service: GenerationService, url: str, args, cfg) -> dict:
    bars = args.bars
    steps = bars * cfg.notes_per_bar
    # A prime from the service itself (also the primed path's first call).
    prime_b64 = base64.b64encode(
        _post(url, "/generate", {"genre": 0, "bars": bars, "seed": 123})
    ).decode()
    workloads = {
        "solo": ("/generate", 1,
                 lambda seed: {"genre": 0, "bars": bars, "seed": seed}),
        "batch16": ("/generate_batch", 16,
                    lambda seed: {"styles_list": [[i % cfg.num_styles]
                                                  for i in range(16)],
                                  "bars": bars, "seed": seed}),
        "primed": ("/generate", 1,
                   lambda seed: {"genre": 0, "bars": bars, "seed": seed,
                                 "prime_midi": prime_b64,
                                 "continuation_only": True}),
    }
    results = {"bars": bars, "reps": args.reps, "workloads": {}}
    out = results["workloads"]
    for name, (path, pieces, payload_fn) in workloads.items():
        _post(url, path, payload_fn(0))          # warm this workload
        times = [_timed_ms(lambda: _post(url, path, payload_fn(1 + rep)))
                 for rep in range(args.reps)]
        out[name] = {"path": path, "pieces_per_request": pieces,
                     **_summary(times, pieces, steps)}
        print(name, out[name], flush=True)

    # -- concurrent16: dynamic request coalescing under parallel load ------
    def concurrent_rep(nthreads: int, seed0: int):
        errs = []
        barrier = threading.Barrier(nthreads + 1)

        def hit(i):
            payload = {"genre": i % 3, "bars": bars, "seed": seed0 + i}
            barrier.wait()
            try:
                _post(url, "/generate", payload)
            except Exception as e:    # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(nthreads)]
        for t in threads:
            t.start()
        calls0 = service.device_calls
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        dt = (time.perf_counter() - t0) * 1e3
        if errs:
            raise RuntimeError(f"concurrent requests failed: {errs[:3]}")
        return dt, service.device_calls - calls0

    nthreads = 16
    concurrent_rep(nthreads, 500)                # warm the protocol path
    reps = [concurrent_rep(nthreads, 1000 + rep * nthreads)
            for rep in range(args.reps)]
    out["concurrent16"] = {
        "path": "/generate (16 threads)", "pieces_per_request": nthreads,
        "device_calls_per_rep": [c for _, c in reps],
        **_summary([t for t, _ in reps], nthreads, steps)}
    print("concurrent16", out["concurrent16"], flush=True)

    # -- mixed_bars: short requests under long co-traffic ------------------
    long_bars = 8 * bars
    _post(url, "/generate", {"genre": 0, "bars": 1, "seed": 9000})
    _post(url, "/generate", {"genre": 0, "bars": long_bars, "seed": 9001})

    def short_reps(seed0: int) -> list:
        return [_timed_ms(lambda: _post(
            url, "/generate", {"genre": 0, "bars": 1, "seed": seed0 + rep}))
            for rep in range(args.reps)]

    quiet = short_reps(9100)
    stop = threading.Event()
    errs = []

    def long_traffic(tid: int) -> None:
        s = 0
        while not stop.is_set():
            try:
                _post(url, "/generate",
                      {"genre": tid % 3, "bars": long_bars,
                       "seed": 9500 + tid * 1000 + s})
            except Exception as e:   # noqa: BLE001 — surfaced below
                errs.append(e)
                return
            s += 1

    hammers = [threading.Thread(target=long_traffic, args=(i,))
               for i in range(2)]
    for t in hammers:
        t.start()
    saved_ratio = service.coalesce_bars_ratio
    try:
        time.sleep(0.2)              # let the co-traffic reach the device
        busy = short_reps(9200)
        # Control: grouping disabled, so the short request rides the long
        # jobs and returns at its own bars after the job's next slice.
        service.coalesce_bars_ratio = 1 << 30
        busy_unbounded = short_reps(9300)
    finally:
        service.coalesce_bars_ratio = saved_ratio
        stop.set()
        for t in hammers:
            t.join()
    if errs:
        raise RuntimeError(f"long co-traffic failed: {errs[:3]}")
    out["mixed_bars"] = {
        "path": f"/generate (1 bar under {long_bars}-bar co-traffic)",
        "long_bars": long_bars,
        "quiet_ms": quiet, "busy_ms": busy,
        "busy_unbounded_ms": busy_unbounded,
        "quiet_p50_ms": _pct(quiet, 0.5),
        "busy_p50_ms": _pct(busy, 0.5), "busy_p95_ms": _pct(busy, 0.95),
        "busy_unbounded_p50_ms": _pct(busy_unbounded, 0.5),
        "busy_unbounded_p95_ms": _pct(busy_unbounded, 0.95),
        "coalesce_bars_ratio": saved_ratio,
    }
    print("mixed_bars", out["mixed_bars"], flush=True)

    # -- overload: bounded admission at the HTTP surface -------------------
    saved_pending = service.max_pending
    service.max_pending = 2
    codes = []
    code_lock = threading.Lock()

    def flood(i: int) -> None:
        try:
            _post(url, "/generate",
                  {"genre": 0, "bars": bars, "seed": 9900 + i})
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        with code_lock:
            codes.append(code)

    floods = [threading.Thread(target=flood, args=(i,)) for i in range(12)]
    try:
        for t in floods:
            t.start()
        for t in floods:
            t.join()
    finally:
        service.max_pending = saved_pending
    out["overload"] = {
        "path": "/generate (12 concurrent, max_pending=2)",
        "status_codes": sorted(codes),
        "shed_503": codes.count(503),
        "served_200": codes.count(200),
    }
    print("overload", out["overload"], flush=True)
    return results


if __name__ == "__main__":
    main()
