"""The traced window: `torch.profiler` over a block of work on the card,
reduced to what the per-layer readers and the result's `breakdown` read.

`profiled(fn)` runs `fn` once under the profiler between two
synchronisations and returns a `Trace`:

  * `window_s`: the block's length by the host clock;
  * `busy_s`: the seconds in which some operation (kernel, copy, set) ran
    on the card, the union of their intervals;
  * `kernels`: name -> (seconds, launches), every device operation;
  * `idle_gaps`: the gaps between device operations, each named by the
    innermost host span open at its middle (the benchmark's own
    `portbench.*` spans, or the program's operator that was running).

Recording the host's operators slows a host-paced program by half and
more (the linear training step: 90-108 ms a step traced against 60
untraced), which would read as idle device time.  So `window` takes the
busy time, the window and the kernels from a run of the device's activity
alone, and names the idle gaps from a second, shorter run that records
the host too.

The reduction itself (`reduce_events`) takes plain (name, on_device,
start_ns, end_ns) tuples, so the CPU tests hold it to hand counts."""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Event = Tuple[str, bool, int, int]
GAP_MIN_NS = 2_000      # gaps shorter than this are launch jitter, not idle


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]
    idle_gaps: Dict[str, float]

    def device_s(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose names
        `match` accepts."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if match(name):
                s += sec
                n += count
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_at(host: Sequence[Event], starts: List[int], outer: List[Event],
             t: int) -> str:
    """The innermost host span open at time t: the shortest of the spans
    that contain it among the last few thousand started before it, else
    the benchmark's own span (`portbench.*`) that contains it."""
    i = bisect.bisect_right(starts, t)
    best, best_len = None, None
    for name, _, a, b in host[max(0, i - 4000):i]:
        if b >= t and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    if best is None:
        best = next((n for n, _, a, b in outer if a <= t <= b), "host")
    return best


def reduce_events(events: Sequence[Event], window_s: float) -> Trace:
    """A host span (`record_function`) also shows on the device's timeline
    under its own name; such mirrors are not device operations."""
    host = sorted((e for e in events if not e[1]), key=lambda e: e[2])
    names = {e[0] for e in host}
    dev = [e for e in events if e[1] and e[0] not in names]
    kernels: Dict[str, List[float]] = {}
    for name, _, a, b in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e9
        k[1] += 1
    merged = _union([(a, b) for _, _, a, b in dev])
    busy = sum(b - a for a, b in merged) / 1e9
    starts = [e[2] for e in host]
    outer = [e for e in host if e[0].startswith("portbench.")]
    gaps: Dict[str, float] = {}
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        if a1 - b0 >= GAP_MIN_NS:
            name = _host_at(host, starts, outer, (a1 + b0) // 2)
            gaps[name] = gaps.get(name, 0.0) + (a1 - b0) / 1e9
    return Trace(window_s, busy,
                 {n: (s, int(c)) for n, (s, c) in kernels.items()}, gaps)


def _kineto_events(prof) -> List[Event]:
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = int(e.start_ns())
        out.append((e.name(), e.device_type() == cuda, a,
                    a + int(e.duration_ns())))
    return out


def window(device_fn: Callable[[], None], host_fn: Callable[[], None],
           device: torch.device) -> Trace:
    """The device's activity over `device_fn`, with the idle gaps of
    `host_fn` named by the host's operators."""
    out = profiled(device_fn, device, host=False)
    out.idle_gaps = profiled(host_fn, device, host=True).idle_gaps
    return out


def profiled(fn: Callable[[], None], device: torch.device,
             host: bool = True) -> Trace:
    """Run fn once under the profiler and reduce its events.  `host=False`
    records the device's activity alone: recording every host operator
    slows a host-paced program enough to change what it does."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    if not acts:                       # the CPU, device only: nothing
        t0 = time.perf_counter()
        fn()
        return reduce_events([], time.perf_counter() - t0)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return reduce_events(_kineto_events(prof), window)
