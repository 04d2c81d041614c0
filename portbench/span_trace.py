"""A training cell's device-only window with its idle gaps named by the
program's own spans.

`idle_by_span(events, spans)` takes the profiler's events as
`trace.reduce_events` does ((name, on_device, start_ns, end_ns) tuples)
and the program's closed spans (`music_generator_tpu_torch/utils/
spans.py`, stamped on the profiler's clock).  Each gap of at least
`trace.GAP_MIN_NS` between device operations goes to the shortest span,
on any thread, open at its middle, else to "outside": the parts sum to
the window's idle time less its shorter gaps and its two ends (before
the first operation, after the last).  `sync_idle_s` sums the
gaps that open while a wait span is open.

    python3 -m portbench.span_trace --workload deepj.train_b64 --seed 7

on the card sets the cell up as a run does, then prints one JSON line:

  * `sync_debug`: the synchronising calls that
    `torch.cuda.set_sync_debug_mode("warn")` reports over two steps, by
    the innermost line of the checkout that made them;
  * `step_ms`: the step's time (host clock, `--steps` steps ended by a
    synchronise) with no profiler, the program's spans off and recording
    in turns (off, on, on, off);
  * `window`: `--steps` steps profiled with the device's activity alone,
    as a traced run's first window: its busy and idle seconds, the step
    time, the device operations a step, idle by span, the sync idle,
    each span name's count, host ms, self host ms and device ms a step,
    and the cell's per-layer readers' values over it (`train_mfu`, which
    reads the measured window, none)."""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from portbench import trace


def _gaps(events: Sequence[trace.Event]) -> List[Tuple[int, int]]:
    """The gaps of at least GAP_MIN_NS between the device's operations,
    as `trace.reduce_events` finds them."""
    host = {e[0] for e in events if not e[1]}
    merged = trace._union([(a, b) for n, dev, a, b in events
                           if dev and n not in host])
    return [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])
            if a1 - b0 >= trace.GAP_MIN_NS]


def idle_by_span(events: Sequence[trace.Event], spans) -> Dict[str, float]:
    """Idle seconds by the shortest program span open at a gap's middle."""
    out: Dict[str, float] = {}
    for b0, a1 in _gaps(events):
        t = (a1 + b0) // 2
        open_ = [s for s in spans if s.start_ns <= t <= s.end_ns]
        name = (min(open_, key=lambda s: s.host_ns).name if open_
                else "outside")
        out[name] = out.get(name, 0.0) + (a1 - b0) / 1e9
    return out


def sync_idle_s(events: Sequence[trace.Event], spans) -> float:
    """Idle seconds in the gaps that open while a wait span is open."""
    waits = [s for s in spans if s.wait]
    return sum((a1 - b0) / 1e9 for b0, a1 in _gaps(events)
               if any(s.start_ns <= b0 <= s.end_ns for s in waits))


def by_name(rec, got: Sequence) -> Dict[str, dict]:
    """Count, host ms, self host ms and device ms of the spans `got`
    (of Recording `rec`), summed by name."""
    out: Dict[str, dict] = collections.defaultdict(
        lambda: {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                 "device_ms": None})
    for s in got:
        d = out[s.name]
        d["count"] += 1
        d["host_ms"] += s.host_ns / 1e6
        d["self_host_ms"] += rec.self_ns(s) / 1e6
        if s.device_ms is not None:
            d["device_ms"] = (d["device_ms"] or 0.0) + s.device_ms
    return dict(out)


def _per_step(table: Dict[str, dict], n: int) -> Dict[str, dict]:
    return {k: {f: None if v is None else v / n for f, v in d.items()}
            for k, d in table.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a window (default: the traffic's "
                         "trace_steps)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from music_generator_tpu_torch.utils import spans
    from portbench import program_spans
    from portbench import run as pr
    from portbench.drivers import train as drv

    root = Path.cwd()
    if not torch.cuda.is_available():
        print("portbench.span_trace: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = pr.load_json(root / "BENCHMARK.json")
    cell = pr._cell(bench, args.workload)
    pb = root / "portbench"
    traffic = pr.load_json(pb / "traffic" / f"{cell['traffic']}.json")
    if traffic["driver"] != "train":
        print("portbench.span_trace: a training cell only", file=sys.stderr)
        return 2
    run = pr.Run(root, cell,
                 pr.load_json(pb / "configs" / f"{cell['config']}.json"),
                 traffic, args.seed, 0.0, True, device, time.time())
    n = args.steps or traffic["trace_steps"]
    ctx = drv.setup(run)
    k = drv.CHECKED_STEPS

    def steps(count: int) -> float:
        nonlocal k
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(count):
            ctx.step(k)
            k += 1
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / count * 1e3

    steps(n)                                            # warm
    syncs = collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        """Count a warning by the innermost frame of the checkout that
        made it, and the frame that raised it."""
        here = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(root))
                and "span_trace" not in f.filename]
        where = (f"{Path(here[-1].filename).name}:{here[-1].lineno}"
                 if here else "-")
        syncs[f"{where} via {Path(filename).name}:{lineno}: "
              f"{str(message)[:60]}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(2):
                ctx.step(k)
                k += 1
        finally:
            torch.cuda.set_sync_debug_mode(0)

    step_ms = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            with spans.recording():
                step_ms[mode].append(steps(n))
        else:
            step_ms[mode].append(steps(n))

    spans.clear_profiled()
    run.mark_setup()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ctx.step(k)
            k += 1
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    run.window_closed()
    events = trace._kineto_events(prof)
    run.profile = tr = trace.reduce_events(events, window_s)
    run.facts.update(trace_steps=n, batch=ctx.B, seq_len=ctx.T,
                     compute_dtype=ctx.cfg.compute_dtype)
    rec = spans.profiled()
    got = program_spans.first_steps(rec.closed(), n)
    readers = {m["name"]: pr._reader(root, m["name"]).read(run)
               for m in bench["per_layer"]
               if cell["name"] in m.get("workloads", [cell["name"]])}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "steps": n,
        "device": torch.cuda.get_device_name(device),
        "sync_debug": dict(syncs), "step_ms": step_ms,
        "window": {
            "window_s": window_s, "busy_s": tr.busy_s,
            "step_ms": window_s / n * 1e3,
            "launches_per_step": sum(c for _, c in tr.kernels.values()) / n,
            "idle_by_span_s": idle_by_span(events, got.inside),
            "sync_idle_s": sync_idle_s(events, got.inside),
            "spans_per_step": _per_step(by_name(rec, got.inside), n),
            "readers": readers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
