"""Served traffic: the program's HTTP service (`GenerationService` behind
`DeepJHTTPServer` on 127.0.0.1) under an open loop of POST /generate
requests, one piece each, from a client in a child process
(`serve_client.py`).

Traffic parameters (`portbench/traffic/<mix>.json`): `rate_per_s` and the
window's `--seconds` fix the number of requests n; `bars` maps a piece's
length in bars to its share of the n; `styles_per_request` the range of
styles mixed in one request; the service's `max_batch`, `slice_bars` and
`warmup_buckets`; `weights`, a committed checkpoint with its sha256;
`timeout_s` a request's limit; `check_pieces` the pieces compared with
the reference; `trace_at` and `trace_s`, where and how long the profiled
part of a `--trace 1` run's window is.  That part records the device's
activity alone: recording the service's host operators as well slowed it
until its queue grew (a traced 40 s window's median latency 2.9 s against
0.53 s untraced), so its idle gaps are not named by host operators.

Every seed sends the same work: the same n, the same lengths, and gaps
that are the same quantiles of the exponential distribution of mean
1 / rate (Poisson arrivals), in an order, with styles and request seeds,
drawn from the seed.  A request's latency is timed from when it was due;
one that fails, is shed (503) or never answers counts in `failed` and
sorts above every latency (as `timeout_s`)."""

from __future__ import annotations

import base64
import json
import math
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import trace
from portbench.drivers.common import load_checkpoint, program_config, sub_seed
from portbench.reference import deepj as ref
from portbench.reference import midi


def schedule(tr: dict, cm: dict, seed: int, seconds: float) -> list:
    """The window's requests: [{"id", "due_s", "bars", "styles", "seed"}]."""
    n = max(1, round(tr["rate_per_s"] * seconds))
    rng = np.random.default_rng(sub_seed(seed, 20))
    lengths = []
    for bars, share in sorted(tr["bars"].items(), key=lambda kv: -kv[1]):
        lengths += [int(bars)] * round(share * n)
    lengths = (lengths + [lengths[0]] * n)[:n]
    rng.shuffle(lengths)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / tr["rate_per_s"]
    rng.shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0]
    lo, hi = tr["styles_per_request"]
    out = []
    for i in range(n):
        k = int(rng.integers(lo, hi + 1))
        styles = sorted(int(s) for s in rng.choice(cm["num_styles"], k,
                                                   replace=False))
        out.append({"id": i, "due_s": float(due[i]), "bars": lengths[i],
                    "styles": styles,
                    "seed": int(rng.integers(0, 2**32 - 1))})
    return out


def _start_server(service):
    from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                                   make_handler)
    server = DeepJHTTPServer(("127.0.0.1", 0), make_handler(service))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, th


def start(r) -> SimpleNamespace:
    """The service with the cell's weights, warmed up, behind its server."""
    from music_generator_tpu_torch.serving import GenerationService

    tr = r.traffic
    cfg = program_config(r)
    weights = load_checkpoint(r.root, tr["weights"])
    service = GenerationService(cfg, params=weights, warmup=True,
                                warmup_buckets=tr["warmup_buckets"],
                                max_batch=tr["max_batch"],
                                slice_bars=tr["slice_bars"], device=r.device)
    server, th = _start_server(service)
    return SimpleNamespace(service=service, server=server, thread=th,
                           weights=weights)


def stop(ctx) -> None:
    ctx.server.shutdown()
    ctx.server.server_close()
    ctx.thread.join()
    del ctx.service


def window(r, ctx, reqs, trace_window: bool = False) -> SimpleNamespace:
    """Send `reqs` through the client and wait for every answer: the
    finished requests by id, the latencies from due time (ms, sorted, a
    missing answer as timeout_s), how late the client sent, the device
    calls made and the window's length."""
    tr = r.traffic
    spec = {"url": f"http://127.0.0.1:{ctx.server.server_address[1]}",
            "timeout_s": tr["timeout_s"],
            "requests": [{"id": q["id"], "due_s": q["due_s"],
                          "path": "/generate",
                          "payload": {"styles": q["styles"],
                                      "bars": q["bars"], "seed": q["seed"]}}
                         for q in reqs]}
    calls0 = ctx.service.device_calls
    t0 = time.perf_counter()
    client = subprocess.Popen([sys.executable, "-m",
                               "portbench.drivers.serve_client"],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              cwd=r.root, text=True)
    client.stdin.write(json.dumps(spec))
    client.stdin.close()
    profile = None
    if trace_window:
        time.sleep(max(0.0, tr["trace_at"] * reqs[-1]["due_s"]
                       - (time.perf_counter() - t0)))
        profile = trace.profiled(lambda: time.sleep(tr["trace_s"]),
                                 r.device, host=False)
    try:
        out = json.loads(client.stdout.read())["results"]
    finally:
        client.wait()
    seconds = time.perf_counter() - t0
    done = {o["id"]: o for o in out if o["status"] == 200 and o["body"]}
    lat = sorted((done[q["id"]]["done_s"] - q["due_s"]) * 1e3
                 if q["id"] in done else tr["timeout_s"] * 1e3
                 for q in reqs)
    return SimpleNamespace(done=done, lat=lat,
                           lags=[o["sent_s"] - o["due_s"] for o in out],
                           calls=ctx.service.device_calls - calls0,
                           window_s=seconds, profile=profile)


def run(r) -> None:
    ctx = start(r)
    reqs = schedule(r.traffic, r.model, r.seed, r.seconds)
    r.mark_setup()
    w = window(r, ctx, reqs, r.trace)
    r.profile = w.profile
    r.attempted, r.failed = len(reqs), len(reqs) - len(w.done)
    r.e2e["request_ms_p95"] = p95(w.lat)
    r.facts.update(pieces=len(w.done), device_calls=w.calls,
                   window_s=w.window_s)
    r.log(f"{len(reqs)} requests, {r.failed} failed; median "
          f"{w.lat[len(w.lat) // 2]:.1f} ms; the client sent them late by "
          f"at most {max(w.lags, default=0.0) * 1e3:.2f} ms (median "
          f"{float(np.median(w.lags or [0.0])) * 1e3:.3f} ms); {w.calls} "
          f"device calls")
    weights = ctx.weights
    stop(ctx)
    r.window_closed()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = served_readings(r, weights, pick(r, reqs, w.done), w.done,
                               ref.Arith())
    for name, limit in r.limits.items():
        r.check(name, readings[name], limit)


def p95(lat) -> float:
    """The nearest-rank 95th percentile of sorted latencies."""
    return lat[math.ceil(0.95 * len(lat)) - 1]


def pick(r, reqs, done) -> list:
    """The pieces compared: the longest finished one and a draw from the
    seed of the others, at most `check_pieces` in all."""
    fin = [q for q in reqs if q["id"] in done]
    if not fin:
        return []
    longest = max(fin, key=lambda q: (q["bars"], -q["id"]))
    rest = [q for q in fin if q is not longest]
    rng = np.random.default_rng(sub_seed(r.seed, 21))
    k = min(len(rest), r.traffic["check_pieces"] - 1)
    return [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k,
                                                           replace=False))]


def served_readings(r, weights, sample, done, ar, decide=None,
                    alter=None) -> dict:
    """draw_gap and volume_gap of the finished pieces `sample` against the
    reference in arithmetic `ar` (`reference.deepj.served_gaps`); `alter`
    changes the decoded play rolls first (a planted fault)."""
    cm, dev = r.model, r.device
    if not sample:
        return {"draw_gap": math.inf, "volume_gap": math.inf}
    steps = [q["bars"] * cm["notes_per_bar"] for q in sample]
    T, N = max(steps), cm["num_notes"]
    play = np.zeros((len(sample), T, N), np.int8)
    replay = np.zeros_like(play)
    vel = np.full((len(sample), T, N), -1, np.int16)
    for i, (q, s) in enumerate(zip(sample, steps)):
        body = base64.b64decode(done[q["id"]]["body"])
        play[i, :s], replay[i, :s], vel[i, :s] = midi.decode(
            body, s, N, r.config["config"]["min_note"])
    if alter is not None:
        alter(play, replay, vel)
    eye = np.eye(cm["num_styles"], dtype=np.float32)
    styles = torch.from_numpy(np.stack([eye[q["styles"]].mean(axis=0)
                                        for q in sample])).to(dev)
    p = {k: v.to(dev) for k, v in weights.items()}
    to = lambda a: torch.from_numpy(a).to(dev)
    return ref.served_gaps(p, cm, styles, to(play), to(replay), to(vel),
                           steps, [q["seed"] for q in sample], ar, decide)
