"""The port's generation service over a real HTTP socket, on the CPU at
test_config(): the HTTP surface and request validation, each test the
counterpart of one in tests/test_serving.py (the JAX service's); and
`serve --from-keras`."""

import base64
import io
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from music_generator_tpu_torch import midi
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.serving import server as server_mod
from music_generator_tpu_torch.training.keras_import import save_keras_weights

from torch_serving_common import CFG, make_service, post, serve


@pytest.fixture(scope="module")
def service():
    return make_service()


@pytest.fixture(scope="module")
def server(service):
    with serve(service) as url:
        yield url


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_stats_reports_scheduler_occupancy(server, service):
    """GET /stats: queue depth, parked jobs, the device-call counter and
    the configured bounds."""
    with urllib.request.urlopen(server + "/stats", timeout=30) as r:
        s = json.loads(r.read())
    assert set(s) == {"pending", "active", "jobs", "device_calls",
                      "max_pending", "max_batch", "slice_bars"}
    assert s["pending"] == 0 and s["jobs"] == len(service._jobs)
    assert s["active"] == service._active
    assert s["max_pending"] == service.max_pending
    assert s["max_batch"] == service.max_batch
    assert s["slice_bars"] == service.slice_bars
    before = s["device_calls"]
    post(server, {"genre": 0, "bars": 1, "seed": 3}).read()
    with urllib.request.urlopen(server + "/stats", timeout=30) as r:
        assert json.loads(r.read())["device_calls"] == before + 1


def test_generate_returns_valid_midi(server):
    with post(server, {"genre": 0, "bars": 1, "seed": 5}) as r:
        assert r.headers["Content-Type"] == "audio/midi"
        data = r.read()
    pattern = midi.read_midifile(io.BytesIO(data))
    assert pattern.resolution == CFG.notes_per_beat


def test_generate_deterministic(server):
    a = post(server, {"styles": [0, 2], "bars": 1, "seed": 9}).read()
    b = post(server, {"styles": [0, 2], "bars": 1, "seed": 9}).read()
    assert a == b
    c = post(server, {"styles": [0, 2], "bars": 1, "seed": 10}).read()
    assert a != c


def test_generate_rejects_oversized_body(server):
    """Bodies over the 1 MB cap 413 from the Content-Length header alone,
    before any of the body is read."""
    host, port = server.rsplit("//", 1)[1].split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: 9999999\r\n\r\n")
        resp = s.recv(4096)
    assert b"413" in resp.split(b"\r\n", 1)[0]


def test_generate_rejects_bad_requests(server):
    for payload in [{"styles": [99]}, {"genre": 7},
                    {"mixture": [1.0, 2.0]}]:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server, payload)
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())


def test_mixture_resolution(service):
    m = service.resolve_mixture({"styles": [0, 1]})
    np.testing.assert_allclose(m[:2], 0.5)
    g = service.resolve_mixture({"genre": 0})
    np.testing.assert_allclose(g[:3], 1 / 3)
    v = service.resolve_mixture({"mixture": [0.0] * CFG.num_styles})
    assert v.shape == (CFG.num_styles,)


def test_generate_bars_clamped(service):
    """bars outside [1, 4096] clamp instead of erroring or running away."""
    small = service.generate(bars=0, seed=1)
    pattern = midi.read_midifile(io.BytesIO(small))
    assert len(pattern) >= 1


def test_temperature_sweep_one_sampler(service):
    """Varied-temperature traffic runs on the one sampler (temperature is
    a per-stream runtime input, so nothing is built per temperature), and
    bad temperatures raise."""
    sampler = service._sampler
    outs = [service.generate(bars=1, seed=3, temperature=t)
            for t in (0.8, 1.3, 2.0)]
    assert service._sampler is sampler
    assert len(set(outs)) > 1          # temperature actually matters
    with pytest.raises(ValueError):
        service.generate(bars=1, temperature=0.0)
    with pytest.raises(ValueError):
        service.generate(bars=1, temperature=-1.0)


def test_generate_batch_endpoint(server, service):
    """N mixtures -> N .mid files from ONE device call, each equal to the
    service API's result for the same composition."""
    payload = {"styles_list": [[0], [1, 2], [3]], "bars": 1, "seed": 6}
    calls = service.device_calls
    with post(server, payload, "/generate_batch") as r:
        body = json.loads(r.read())
    assert service.device_calls == calls + 1
    files = [base64.b64decode(f) for f in body["files"]]
    assert len(files) == 3
    for f in files:
        assert midi.read_midifile(io.BytesIO(f)).resolution == \
            CFG.notes_per_beat
    mixtures = [service.resolve_mixture({"styles": s})
                for s in payload["styles_list"]]
    assert files == service.generate_batch(mixtures, bars=1, seed=6)


def test_generate_rejects_invalid_prime(server):
    bad = base64.b64encode(b"not a midi file").decode()
    for prime in (bad, "!!!"):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server, {"genre": 0, "bars": 1, "prime_midi": prime})
        assert e.value.code == 400


def test_generate_batch_rejects_bad(service):
    with pytest.raises(ValueError):
        service.generate_batch([], bars=1)
    with pytest.raises(ValueError):
        service.generate_batch(
            [service.resolve_mixture({"genre": 0})] * 65, bars=1)


def test_out_of_range_seed_is_http_400(server):
    for bad_seed in (-1, 2 ** 32):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server, {"genre": 0, "bars": 1, "seed": bad_seed})
        assert e.value.code == 400
        assert "seed" in json.loads(e.value.read())["error"]


def test_chunked_transfer_encoding_rejected(server):
    """A chunked body must not read as empty (a 200 with default
    parameters): the server answers 411 and closes the connection."""
    host, port = server.rsplit("//", 1)[1].split(":")
    body = json.dumps({"genre": 1, "bars": 1}).encode()
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n"
                  + hex(len(body))[2:].encode() + b"\r\n" + body
                  + b"\r\n0\r\n\r\n")
        resp = s.recv(4096)
    assert b"411" in resp.split(b"\r\n", 1)[0]


def test_serve_from_keras(service, monkeypatch, tmp_path, capsys):
    """serve --from-keras: the service serve_main builds from a Keras 2
    file holds the file's weights (the fixture's seed-0 weights) bit for
    bit and answers with the fixture service's bytes; --params and
    --from-keras exclude each other."""
    h5 = str(tmp_path / "w.h5")
    save_keras_weights(build_model(CFG, "cpu", seed=0).state_dict(), h5)
    monkeypatch.setattr(server_mod, "default_config", lambda: CFG)
    built = []
    real = server_mod.GenerationService

    def capture(**kwargs):
        built.append(real(**kwargs))
        return built[-1]

    monkeypatch.setattr(server_mod, "GenerationService", capture)
    monkeypatch.setattr(server_mod.DeepJHTTPServer, "serve_forever",
                        lambda self: None)
    server_mod.serve_main(["--device", "cpu", "--port", "0", "--from-keras",
                           h5, "--warmup-buckets", "1", "--max-batch", "4"])
    assert f"Loaded Keras weights from {h5}" in capsys.readouterr().out
    got, want = built[0].model.state_dict(), service.model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    mix = service.resolve_mixture({"genre": 1})
    assert built[0].generate_batch([mix], bars=1, seed=5) == \
        service.generate_batch([mix], bars=1, seed=5)
    with pytest.raises(SystemExit):
        server_mod.serve_main(["--device", "cpu", "--params", "w.npz",
                               "--from-keras", h5])
