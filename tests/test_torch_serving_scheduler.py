"""The port's generation service on the CPU at test_config(): coalescing,
shortest-group-first selection with aging, admission and warm-up, each test
the counterpart of one in tests/test_serving.py (the JAX service's)."""

import numpy as np
import pytest

from music_generator_tpu_torch.serving import ServiceOverloaded
from music_generator_tpu_torch.serving.server import _Pending

from torch_serving_common import make_service, solo


@pytest.fixture(scope="module")
def service():
    return make_service()


def _queue(service, reqs):
    with service._pending_lock:
        service._pending.extend(reqs)


def _pass(service):
    with service._lock:
        service._run_pending_locked()


def test_coalesced_batch_single_device_call_matches_solo(service):
    """Three queued requests with different (mixture, bars, seed,
    temperature) drain in ONE device call, each response byte-equal to the
    direct path for that request alone."""
    mixes = [service.resolve_mixture({"genre": g}) for g in (0, 1, 0)]
    reqs = [_Pending(mixes[0], 2, 5, 1.0),
            _Pending(mixes[1], 1, 9, 0.8),
            _Pending(mixes[2], 2, 5, 1.3)]
    _queue(service, reqs)
    before = service.device_calls
    _pass(service)
    assert service.device_calls == before + 1
    for r in reqs:
        assert r.done.is_set() and r.error is None
        assert r.result == solo(service, r)


def test_coalesced_error_is_per_request(service):
    """A request that fails validation raises in ITS caller before it ever
    touches the queue."""
    with pytest.raises(ValueError):
        service.generate(bars=1, seed=-1)
    with pytest.raises(ValueError):
        service.generate(bars=1, temperature=200.0)
    with service._pending_lock:
        assert not service._pending


def test_coalesced_mixture_is_validated(service):
    """A malformed mixture passed through the Python API fails its own
    caller before it can reach a shared device call."""
    with pytest.raises(ValueError):
        service.generate(mixture=np.zeros(3, np.float32), bars=1)
    with service._pending_lock:
        assert not service._pending


def test_coalesce_bars_ratio_bounds_surplus(service):
    """A coalesced batch mixes only requests within coalesce_bars_ratio:
    of 1-, 8- and 2-bar requests the first drain takes {1, 2} and leaves
    the 8-bar one queued; the second takes it."""
    assert service.coalesce_bars_ratio == 4
    mix = service.resolve_mixture({"genre": 0})
    reqs = [_Pending(mix, 1, 21, 1.0),
            _Pending(mix, 8, 22, 1.0),
            _Pending(mix, 2, 23, 1.0)]
    _queue(service, reqs)
    before = service.device_calls
    _pass(service)
    assert reqs[0].done.is_set() and reqs[2].done.is_set()
    assert not reqs[1].done.is_set()          # the 8-bar one stayed queued
    _pass(service)
    assert reqs[1].done.is_set()
    assert service.device_calls == before + 2
    for r in reqs:
        assert r.error is None
        assert r.result == solo(service, r)


def test_aged_request_anchors_despite_shorter_traffic(service):
    """A request skipped coalesce_max_skips times anchors the next batch
    even when shorter requests are pending."""
    mix = service.resolve_mixture({"genre": 1})
    long_req = _Pending(mix, 16, 41, 1.0)
    long_req.skips = service.coalesce_max_skips
    shorts = [_Pending(mix, 1, 42, 1.0), _Pending(mix, 1, 43, 1.0)]
    _queue(service, [long_req] + shorts)
    _pass(service)                        # starts the aged 16-bar job
    assert not long_req.done.is_set()     # 16 bars > one 8-bar slice
    assert long_req in [r for j in service._jobs for r in j.batch]
    assert not shorts[0].done.is_set()    # outside 4x of the 16-bar anchor
    for _ in range(6):
        if long_req.done.is_set() and all(r.done.is_set() for r in shorts):
            break
        _pass(service)
    assert long_req.done.is_set() and long_req.error is None
    for r in shorts:
        assert r.done.is_set() and r.error is None


def test_capacity_skip_does_not_age_ratio_reject_does(service):
    """Only RATIO rejections age: a request left queued because the batch
    hit max_batch must not, or under load the whole queue would age into
    FIFO."""
    mix = service.resolve_mixture({"genre": 0})
    shorts = [_Pending(mix, 1, i, 1.0)
              for i in range(service.max_batch + 2)]
    long_req = _Pending(mix, 8, 99, 1.0)    # outside 4x of a 1-bar anchor
    # The long request sits near the front so selection examines it while
    # the batch still has room (a pure ratio rejection).
    _queue(service, [shorts[0], long_req] + shorts[1:])
    batch = service._select_batch()
    try:
        assert len(batch) == service.max_batch
        assert long_req.skips == 1
        leftover = [r for r in shorts if r not in batch]
        assert leftover and all(r.skips == 0 for r in leftover)
    finally:
        with service._pending_lock:
            service._pending = []
            service._active = 0


def test_long_request_ages_at_max_batch_one(service):
    """At max_batch=1 every selection fills at once; a long request facing
    steady short traffic still ages through the ratio term and anchors
    after coalesce_max_skips passes."""
    saved = service.max_batch
    service.max_batch = 1
    mix = service.resolve_mixture({"genre": 0})
    long_req = _Pending(mix, 64, 9, 1.0)
    try:
        _queue(service, [long_req])
        for k in range(service.coalesce_max_skips):
            _queue(service, [_Pending(mix, 1, k, 1.0)])
            batch = service._select_batch()
            assert [r.bars for r in batch] == [1]   # short anchors...
            assert long_req.skips == k + 1          # ...but the long ages
        _queue(service, [_Pending(mix, 1, 99, 1.0)])
        assert service._select_batch() == [long_req]   # aged anchor
    finally:
        service.max_batch = saved
        with service._pending_lock:
            service._pending = []
            service._active = 0


def test_admission_counts_parked_jobs(service):
    """max_pending bounds queued PLUS in-flight requests: a request
    selected into a parked job counts until its done event is set."""
    saved = service.max_pending
    service.max_pending = 2
    mix = service.resolve_mixture({"genre": 0})
    try:
        with service._pending_lock:
            service._active = 2          # two requests parked in jobs
        with pytest.raises(ServiceOverloaded):
            service._coalesced(mix, 1, 0, 1.0)
    finally:
        service.max_pending = saved
        with service._pending_lock:
            service._active = 0
            service._pending = []


def test_retire_balances_selection(service):
    """Every request _select_batch admits to the in-flight count is
    retired exactly once, so _active returns to zero after any mix of
    outcomes."""
    mix = service.resolve_mixture({"genre": 0})
    reqs = [_Pending(mix, bars, i, 1.0)
            for i, bars in enumerate([1, 8, 16])]
    _queue(service, reqs)
    with service._lock:
        while any(not r.done.is_set() for r in reqs):
            service._run_pending_locked()
    assert all(r.error is None and r.result[:4] == b"MThd" for r in reqs)
    assert service._active == 0 and not service._jobs


def test_coalesced_encode_failure_is_per_request(service, monkeypatch):
    """One request's encode failure must not poison its co-batched
    siblings."""
    mix = service.resolve_mixture({"genre": 0})
    reqs = [_Pending(mix, 1, 31, 1.0), _Pending(mix, 1, 32, 1.0)]
    real_encode = type(service)._encode_midi
    calls = {"n": 0}

    def flaky_encode(self, roll):
        calls["n"] += 1
        if calls["n"] == 1:       # the first request's encode blows up
            raise RuntimeError("boom")
        return real_encode(self, roll)

    monkeypatch.setattr(type(service), "_encode_midi", flaky_encode)
    _queue(service, reqs)
    _pass(service)
    assert isinstance(reqs[0].error, RuntimeError)
    assert reqs[1].error is None and reqs[1].result is not None
    monkeypatch.undo()
    assert reqs[1].result == solo(service, reqs[1])


def test_warmup_runs_every_bucket(service, monkeypatch, capsys):
    """warmup(N) runs one 1-bar batch per power-of-two bucket up to N
    (capped at max_batch, which joins as the top bucket when it is not a
    power of two) and prints the seconds it took."""
    calls = service.device_calls
    assert service.warmup(2) == [1, 2]
    assert service.device_calls == calls + 2
    assert "warmup: buckets [1, 2] on cpu in" in capsys.readouterr().out
    sizes = []
    monkeypatch.setattr(service, "generate_batch",
                        lambda mixtures, bars: sizes.append(
                            (len(mixtures), bars)))
    monkeypatch.setattr(service, "max_batch", 6)
    assert service.warmup(8) == [1, 2, 4, 6]
    assert sizes == [(1, 1), (2, 1), (4, 1), (6, 1)]
    assert service.warmup(None) == [1]
