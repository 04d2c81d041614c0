"""The port's generation service over a real HTTP socket, on the CPU at
test_config(): primed requests, concurrent traffic and load shedding, each
test the counterpart of one in tests/test_serving.py (the JAX service's)."""

import base64
import io
import json
import threading
import urllib.error

import numpy as np
import pytest

from music_generator_tpu_torch import midi
from music_generator_tpu_torch.data.dataset import clamp_midi
from music_generator_tpu_torch.serving import ServiceOverloaded

from torch_serving_common import CFG, make_service, post, serve


@pytest.fixture(scope="module")
def service():
    return make_service()


@pytest.fixture(scope="module")
def server(service):
    with serve(service) as url:
        yield url


def test_generate_primed_continuation(server, service):
    """POST /generate with prime_midi: the reply's roll starts with the
    prime's notes bit for bit, continuation_only drops the echo, and both
    are deterministic.

    The echo's volumes are those of the prime re-encoded: the codec keeps
    a held note at its note-on velocity, so a decoded prime whose held
    notes change volume does not survive encoding (the JAX package's codec
    decodes these bytes the same way)."""
    prime_bytes = service.generate(mixture=None, bars=1, seed=3)
    prime_b64 = base64.b64encode(prime_bytes).decode()
    payload = {"genre": 0, "bars": 1, "seed": 3, "prime_midi": prime_b64}
    with post(server, payload) as r:
        full = r.read()
    pattern = midi.read_midifile(io.BytesIO(full))
    assert pattern.resolution == CFG.notes_per_beat

    def decode(data):
        return clamp_midi(midi.midi_decode(
            midi.read_midifile(io.BytesIO(data)), CFG.midi_max_notes,
            config=CFG), CFG)

    roll_prime = decode(prime_bytes)
    echo = decode(full)[:roll_prime.shape[0]]
    np.testing.assert_array_equal(echo[..., :2], roll_prime[..., :2])
    np.testing.assert_array_equal(
        echo, decode(service._encode_midi(roll_prime)))
    payload["continuation_only"] = True
    with post(server, payload) as r:
        cont = r.read()
    assert cont != full
    with post(server, payload) as r:
        assert r.read() == cont


def _hammer(server, payloads):
    """POST every payload from its own thread at once; returns the bodies
    in order.  Every thread must finish and none may fail."""
    results, errors = [None] * len(payloads), []

    def hit(i):
        try:
            results[i] = post(server, payloads[i]).read()
        except Exception as e:       # noqa: BLE001 — record, assert below
            errors.append((i, e))

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not [t for t in threads if t.is_alive()], "requests hung"
    assert not errors, errors
    return results


def test_concurrent_requests_serialize_correctly(server):
    """Several threads at once: every request succeeds and each response
    equals its sequential counterpart (no state leaks between requests
    through the shared sampler)."""
    seeds = [11, 12, 13, 14]
    expected = {s: post(server, {"genre": 0, "bars": 1, "seed": s}).read()
                for s in seeds}
    got = _hammer(server, [{"genre": 0, "bars": 1, "seed": s}
                           for s in seeds * 2])
    assert got == [expected[s] for s in seeds * 2]


def test_concurrent_heterogeneous_requests_match_sequential(server):
    """Concurrent traffic with different bars, seeds and temperatures:
    however the leader coalesces them, every response equals its
    sequential re-request."""
    payloads = [{"genre": g % 3, "bars": 1 + (g % 2), "seed": 40 + g,
                 "temperature": 1.0 + 0.1 * g} for g in range(4)]
    got = _hammer(server, payloads)
    for body, p in zip(got, payloads):
        assert body == post(server, p).read()


def test_overload_sheds_503(server, service):
    """Past max_pending, /generate sheds with HTTP 503 + Retry-After."""
    saved = service.max_pending
    service.max_pending = 0       # every admission attempt now sheds
    try:
        with pytest.raises(ServiceOverloaded):
            service.generate(bars=1, seed=77)
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server, {"genre": 0, "bars": 1, "seed": 77})
        assert e.value.code == 503
        assert e.value.headers["Retry-After"]
        assert "error" in json.loads(e.value.read())
    finally:
        service.max_pending = saved
    assert service.generate(bars=1, seed=77)[:4] == b"MThd"
