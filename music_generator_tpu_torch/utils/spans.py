"""Named spans of the port's work, on the torch profiler's clock.

    with spans.span("train.optimizer"):
        state.optimizer.step()

Recording is off unless a `Recording` is open (`with spans.recording() as
rec:`) or the torch profiler runs.  Off, `span()` returns one shared no-op
context manager after reading two module-level flags: it records no event,
registers no hook and allocates nothing.

On, each span keeps its name, its parent (the innermost span open on the
same thread), the thread, whether it is a wait (the host blocked on the
device), its host start and end in `time.time_ns()` nanoseconds (the
base of the profiler's event stamps, to which it also converts the
device's), and, once CUDA is in use, a pair of timing events recorded on
the current stream at enter and exit.  It also enters
`torch.profiler.record_function(name)`, so that a profiler recording host
activity shows it.  Nothing is written while the work runs: a
`Recording` resolves its events into `device_ms` (the stream's time from
reaching the span's start to reaching its end, idle inside it included)
when it stops or is read, waiting for them if they are still queued.

Spans recorded under the profiler with no `Recording` open go to one
process-wide recording, `profiled()`, so that a profile of the program
carries them without the profiling code's knowing of them; it keeps them
until `clear_profiled()`.

`backward_span` opens and closes a span from autograd hooks, on the
thread that runs the backward (a device thread on CUDA, where the span has
no parent)."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import List, Optional, Sequence

import torch
import torch.autograd.profiler as _profiler


@dataclasses.dataclass
class Span:
    id: int
    name: str
    parent: Optional[int]
    thread: int
    wait: bool
    start_ns: int
    end_ns: int = 0                       # 0 while the span is open
    device_ms: Optional[float] = None
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _rf: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns


class Recording:
    """The spans recorded while it is open, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []

    def start(self) -> "Recording":
        global _ON
        _OPEN.append(self)
        _ON = True
        return self

    def stop(self) -> "Recording":
        global _ON
        _OPEN.remove(self)
        _ON = bool(_OPEN)
        self.resolve()
        return self

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()

    def resolve(self) -> None:
        """Turn the closed spans' CUDA events into `device_ms`."""
        for s in self.spans:
            if s._events is not None and s.end_ns:
                begin, end = s._events
                end.synchronize()
                s.device_ms = begin.elapsed_time(end)
                s._events = None

    def closed(self) -> List[Span]:
        return [s for s in self.spans if s.end_ns]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: Span) -> int:
        """The span's host time less the part of it its children cover."""
        covered, reach = 0, span.start_ns
        for a, b in sorted((max(c.start_ns, span.start_ns),
                            min(c.end_ns, span.end_ns))
                           for c in self.children(span) if c.end_ns):
            a = max(a, reach)
            if b > a:
                covered += b - a
                reach = b
        return span.host_ns - covered


recording = Recording               # with spans.recording() as rec: ...
_ON = False                         # a Recording is open
_OPEN: List[Recording] = []
_PROFILED = Recording()
_IDS = itertools.count()
_THREAD = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoSpan()


def profiled() -> Recording:
    """The spans recorded under the profiler with no `Recording` open,
    their device times resolved."""
    _PROFILED.resolve()
    return _PROFILED


def clear_profiled() -> None:
    _PROFILED.spans.clear()


def is_on() -> bool:
    return _ON or _profiler._is_profiler_enabled


def _stack() -> List[Span]:
    st = getattr(_THREAD, "stack", None)
    if st is None:
        st = _THREAD.stack = []
    return st


def begin(name: str, wait: bool = False) -> Span:
    """Open a span on this thread (recording must be on).  Its host start
    is stamped last and its end first, so that they bracket the work and
    not the recording's own calls."""
    st = _stack()
    s = Span(next(_IDS), name, st[-1].id if st else None,
             threading.get_ident(), wait, 0)
    (_OPEN[-1] if _OPEN else _PROFILED).spans.append(s)
    st.append(s)
    s._rf = torch.autograd.profiler.record_function(name).__enter__()
    if torch.cuda.is_initialized():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        s._events = (ev,)
    s.start_ns = time.time_ns()
    return s


def end(s: Span) -> None:
    """Close a span that `begin` opened on this thread."""
    s.end_ns = time.time_ns()
    if s._events is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        s._events = (s._events[0], ev)
    s._rf.__exit__(None, None, None)
    s._rf = None
    st = _stack()
    if st and st[-1] is s:
        st.pop()
    elif s in st:
        st.remove(s)


class _Span:
    __slots__ = ("name", "wait", "span")

    def __init__(self, name: str, wait: bool):
        self.name, self.wait = name, wait

    def __enter__(self) -> Span:
        self.span = begin(self.name, self.wait)
        return self.span

    def __exit__(self, *exc) -> None:
        end(self.span)


def span(name: str, wait: bool = False):
    """A context manager over one span; `wait` marks the host blocking on
    the device.  The shared no-op when recording is off."""
    if not (_ON or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, wait)


def backward_span(name: str, outputs: Sequence[torch.Tensor],
                  inputs: Sequence[torch.Tensor]) -> None:
    """A span over autograd's backward from `outputs` to `inputs`: opened
    by a hook when the gradient reaches the first of `outputs`, closed by
    hooks once it has reached every one of `inputs`.  Registers nothing
    when recording is off or no gradient will flow."""
    if not (_ON or _profiler._is_profiler_enabled):
        return
    outs = [t for t in outputs if t.requires_grad]
    ins = [t for t in inputs if t.requires_grad]
    if not outs or not ins:
        return
    state = {"span": None, "left": len(ins)}

    def opened(grad):
        if state["span"] is None and is_on():
            state["span"] = begin(name)

    def reached(grad):
        state["left"] -= 1
        if state["left"] == 0 and state["span"] is not None:
            end(state["span"])

    for t in outs:
        t.register_hook(opened)
    for t in ins:
        t.register_hook(reached)
