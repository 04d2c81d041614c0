"""The port's generation service on the CPU at test_config(): time-sliced
jobs, early completion of riders, and the fate of a job whose device call
or close fails.  Each test but the last three is the counterpart of one
in tests/test_serving.py (the JAX service's); the last three check that a
finished member's rows leave the job's host buffers, and that a request
returns as soon as the pass that served it ends."""

import numpy as np
import pytest

from music_generator_tpu_torch.serving.server import _Job, _Pending

from torch_serving_common import CFG, make_service, solo


@pytest.fixture(scope="module")
def service():
    return make_service()


def _queue(service, reqs):
    with service._pending_lock:
        service._pending.extend(reqs)


def _pass(service):
    with service._lock:
        service._run_pending_locked()


def test_shortest_group_drains_first(service):
    """A 1-bar request enqueued AFTER two 64-bar requests still anchors
    the next drain, so it waits for the call in flight, not for the long
    group."""
    mix = service.resolve_mixture({"genre": 0})
    longs = [_Pending(mix, 64, 31, 1.0), _Pending(mix, 64, 32, 1.0)]
    short = _Pending(mix, 1, 33, 1.0)
    _queue(service, longs + [short])
    _pass(service)
    assert short.done.is_set() and short.error is None
    assert not longs[0].done.is_set() and not longs[1].done.is_set()
    assert all(r.skips == 1 for r in longs)
    for _ in range(64 // service.slice_bars + 2):   # 8 slices + slack
        if all(r.done.is_set() for r in longs):
            break
        _pass(service)
    for r in longs:
        assert r.done.is_set() and r.error is None


def test_time_sliced_job_interleaves_and_matches_solo(service):
    """A 24-bar job parks between 8-bar slices; a 1-bar request arriving
    mid-job is served on the next alternation pass, and the interleaved
    job's bytes still equal its solo run."""
    mix = service.resolve_mixture({"genre": 2})
    long_req = _Pending(mix, 24, 51, 1.0)
    _queue(service, [long_req])
    _pass(service)                        # starts the job, slice 1/3
    assert not long_req.done.is_set() and len(service._jobs) == 1
    short = _Pending(mix, 1, 52, 1.0)
    _queue(service, [short])
    _pass(service)                        # the job's turn: slice 2/3
    _pass(service)                        # pending's turn: the short
    assert short.done.is_set() and short.error is None
    assert not long_req.done.is_set()     # still one slice to go
    _pass(service)                        # slice 3/3
    assert long_req.done.is_set() and long_req.error is None
    for r in (long_req, short):
        assert r.result == solo(service, r)


def test_rider_completes_at_its_own_bars(service):
    """A 4-bar rider coalesced with a 16-bar request finishes after the
    FIRST slice, not with its longest co-rider."""
    mix = service.resolve_mixture({"genre": 0})
    rider = _Pending(mix, 4, 61, 1.0)
    long_req = _Pending(mix, 16, 62, 1.0)
    _queue(service, [rider, long_req])
    _pass(service)                        # one batch (16 <= 4*4), slice 1
    assert rider.done.is_set() and rider.error is None
    assert not long_req.done.is_set()
    _pass(service)                        # slice 2 finishes the long one
    assert long_req.done.is_set() and long_req.error is None
    for r in (rider, long_req):
        assert r.result == solo(service, r)


def test_failed_advance_closes_job_handle(service):
    """A failed device call mid-job closes the incremental handle (freeing
    its state on the card) and fails the members."""

    class FakeGen:
        closed = 0

        def advance(self, num_chunks=1):
            raise RuntimeError("device lost")

        def close(self):
            self.closed += 1

    mix = service.resolve_mixture({"genre": 0})
    r = _Pending(mix, 8, 7, 1.0)
    gen = FakeGen()
    job = _Job([r], gen, bars_max=8)
    try:
        service._advance_job(job)
    finally:
        with service._pending_lock:   # the job bypassed _select_batch:
            service._active = 0       # undo its retire
    assert gen.closed == 1
    assert r.done.is_set() and isinstance(r.error, RuntimeError)
    assert job.bars_done >= job.bars_max and not job.parts


def test_finished_job_close_failure_keeps_results(service):
    """The finished path's close is best-effort too: a close() that raises
    must not turn computed results into an exception on the serving
    thread, and the job still releases its host rows."""
    spb = CFG.notes_per_bar

    class FakeGen:
        def advance(self, num_chunks=1):
            return np.zeros(
                (1, service.slice_bars * spb, CFG.num_notes, 3), np.float32)

        def close(self):
            raise ConnectionError("channel broken")

    mix = service.resolve_mixture({"genre": 0})
    r = _Pending(mix, service.slice_bars, 3, 1.0)
    job = _Job([r], FakeGen(), bars_max=service.slice_bars)
    try:
        service._advance_job(job)              # must not raise
    finally:
        with service._pending_lock:
            service._active = 0
    assert r.done.is_set() and r.error is None
    assert r.result is not None and r.result[:4] == b"MThd"
    assert not job.parts


def test_finished_member_rows_leave_the_job(service):
    """Once a member's result is encoded its rows leave the job's host
    buffers, and a member still running keeps a copy of its own rows, not
    a view that would hold every member's slice."""
    spb = CFG.notes_per_bar
    steps = service.slice_bars * spb

    class FakeGen:
        def advance(self, num_chunks=1):
            notes = np.zeros((2, steps, CFG.num_notes, 3), np.float32)
            notes[:, ::2, 5] = (1.0, 1.0, 0.5)
            return notes

        def close(self):
            pass

    mix = service.resolve_mixture({"genre": 0})
    rider, long_req = _Pending(mix, 4, 1, 1.0), _Pending(mix, 16, 2, 1.0)
    job = _Job([rider, long_req], FakeGen(), bars_max=16)
    try:
        service._advance_job(job)
        assert rider.done.is_set() and rider.result[:4] == b"MThd"
        assert not long_req.done.is_set()
        assert job.parts[0] == []
        assert len(job.parts[1]) == 1 and job.parts[1][0].base is None
        assert job.parts[1][0].shape == (steps, CFG.num_notes, 3)
        service._advance_job(job)
        assert long_req.done.is_set() and long_req.error is None
        assert not job.parts
    finally:
        with service._pending_lock:
            service._active = 0
    full = np.zeros((2 * steps, CFG.num_notes, 3), np.float32)
    full[::2, 5] = (1.0, 1.0, 0.5)
    assert long_req.result == service._encode_midi(full)
    assert rider.result == service._encode_midi(full[:4 * spb])


def test_follower_returns_when_its_pass_is_done(monkeypatch):
    """Under long co-traffic a short request returns as soon as the pass
    that served it ends, not when the thread leading the passes lets go
    of the execution lock (which it takes again at once while its own
    128-bar job runs).  Stress: a leader, riders on more threads than
    cores, a short switch interval; the sampler is a stand-in whose every
    slice takes 50 ms."""
    import sys
    import threading
    import time

    steps = 8 * CFG.notes_per_bar

    class SlowGen:
        def __init__(self, G):
            self.G = G

        def advance(self, num_chunks=1):
            time.sleep(0.05)
            return np.zeros((self.G, num_chunks * steps, CFG.num_notes, 3),
                            np.float32)

        def close(self):
            pass

    class SlowSampler:
        def begin(self, styles, **kwargs):
            return SlowGen(len(styles))

    service = make_service()
    monkeypatch.setattr(service, "_sampler", SlowSampler())
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        long_done = []
        leader = threading.Thread(target=lambda: long_done.append(
            service.generate(bars=128, seed=1)))
        leader.start()
        deadline = time.monotonic() + 30
        while service.device_calls == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert service.device_calls, "the 128-bar job never ran a slice"
        rider_out = []
        riders = [threading.Thread(target=lambda s=s: rider_out.append(
            service.generate(bars=1, seed=s))) for s in range(2, 10)]
        for t in riders:
            t.start()
        for t in riders:
            t.join(timeout=30)
        assert not [t for t in riders if t.is_alive()], "riders hung"
        assert len(rider_out) == 8 and not long_done
        leader.join(timeout=30)
        assert not leader.is_alive() and len(long_done) == 1
    finally:
        sys.setswitchinterval(switch)
    assert service._active == 0 and not service._jobs
    assert all(r[:4] == b"MThd" for r in rider_out + long_done)


def test_follower_returns_while_the_leader_holds_the_lock():
    """The protocol itself: this thread leads and holds the execution lock,
    serves a queued request in one pass and signals the pass's end; the
    request's thread returns then, before the lock is released."""
    import threading
    import time

    service = make_service()
    with service._turn:
        service._leading = True              # this thread leads
    out = []
    try:
        with service._lock:
            rider = threading.Thread(target=lambda: out.append(
                service.generate(bars=1, seed=2)))
            rider.start()
            deadline = time.monotonic() + 30
            while not service._pending and time.monotonic() < deadline:
                time.sleep(0.001)
            service._run_pending_locked()    # serves the rider
            with service._turn:
                service._turn.notify_all()   # the pass ended; lock held
            rider.join(timeout=10)
            assert not rider.is_alive(), \
                "the follower waited for the execution lock"
    finally:
        with service._turn:
            service._leading = False
            service._turn.notify_all()
        rider.join(timeout=60)
    assert out and out[0][:4] == b"MThd"
