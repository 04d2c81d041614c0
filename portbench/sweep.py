"""The rate sweep that fixes a served cell's `rate_per_s`: one service,
set up once, under the cell's traffic at each rate in turn, each window
`--seconds` of arrivals.

    python3 -m portbench.sweep --workload deepj.serve_mixed \
        --rates 4 8 12 16 --seconds 20 --seed 1

For each rate it prints one JSON line: requests, failed, the median and
95th-percentile latency from due time, pieces a second, device calls, and
the drain: the seconds from the last request's due time to the last
answer.  A rate the service sustains answers every request, and its
drain stays near the service time of the longest request; a backlog that
grows through the window shows as a drain that grows with the window."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from portbench import control
from portbench.drivers import serve as sd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None, help="a file for the lines too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    r = control._run(Path.cwd(), args.workload, args.seed,
                     torch.device("cuda", 0))
    ctx = sd.start(r)
    for rate in args.rates:
        r.traffic["rate_per_s"] = rate
        reqs = sd.schedule(r.traffic, r.model, args.seed, args.seconds)
        w = sd.window(r, ctx, reqs)
        line = json.dumps({
            "rate_per_s": rate, "requests": len(reqs),
            "failed": len(reqs) - len(w.done),
            "p50_ms": w.lat[len(w.lat) // 2], "p95_ms": sd.p95(w.lat),
            "pieces_per_s": len(w.done) / w.window_s,
            "device_calls": w.calls, "window_s": w.window_s,
            "drain_s": w.window_s - reqs[-1]["due_s"],
            "last_due_s": reqs[-1]["due_s"],
            "max_lag_ms": max(w.lags, default=0.0) * 1e3})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    sd.stop(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
