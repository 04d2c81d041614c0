"""The program's own spans over a traced run's steps, for the per-layer
readers of the training cells.

The port records its spans (`music_generator_tpu_torch/utils/spans.py`)
while the torch profiler runs, into one process-wide recording.  A
training cell's traced run profiles `trace_steps` steps with the device's
activity alone, then `trace_host_steps` with the host's too
(`trace.window`).  `steps(run)` takes the first `trace_steps` `train.step`
spans of this run, between the end of set-up and the window's close:
those of the device-only window on the card.  On the CPU that window runs
without the profiler, so they are the host-recorded window's.

It returns None where the program has no spans (a checkout before them)
or recorded none, and the readers then report nothing."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass
class Steps:
    steps: list                # the train.step spans
    inside: list               # every span within them, any thread

    @property
    def count(self) -> int:
        return len(self.steps)

    def within(self, match: Callable[[object], bool]) -> list:
        return [s for s in self.inside if match(s)]

    def device_ms(self, match: Callable[[object], bool]) -> Optional[float]:
        """The device ms a step of the spans `match` accepts; None when
        one has none (no card) or there is no such span."""
        got = self.within(match)
        if not got or any(s.device_ms is None for s in got):
            return None
        return sum(s.device_ms for s in got) / self.count


def first_steps(got: List, n: int) -> Optional[Steps]:
    """The first `n` `train.step` spans of the closed spans `got` (in the
    order they opened), and every span within them."""
    top = [s for s in got if s.name == "train.step"][:n]
    if not top:
        return None
    inside = [s for s in got if any(t.start_ns <= s.start_ns
                                    and s.end_ns <= t.end_ns for t in top)]
    return Steps(top, inside)


def steps(run) -> Optional[Steps]:
    try:
        from music_generator_tpu_torch.utils import spans
    except ImportError:
        return None
    n = run.facts.get("trace_steps")
    if not n or run.setup_s is None or run.closed_at is None:
        return None
    lo, hi = int((run.t0 + run.setup_s) * 1e9), int(run.closed_at * 1e9)
    return first_steps([s for s in spans.profiled().closed()
                        if lo <= s.start_ns and s.end_ns <= hi], n)
