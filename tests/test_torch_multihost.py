"""Serving across ranks (serving/multihost.py) on the CPU:

  * two ranks of tools/mp_worker.py over gloo, leader and follower of the
    replay channel on 127.0.0.1, answer byte for byte what a one-process
    service answers (a bucket-1 /generate, a /generate_batch of 4, a
    16-bar /generate time-sliced in two jobs' slices, a primed
    /generate), and the follower runs the pitch loop as often as the
    leader;
  * the JAX package's two contracts, ported: a follower whose begin()
    failed fails the leader's advance() with that cause, and serve_main
    joins the process group before anything else;
  * the channel: a peer with the wrong secret is refused and takes no
    follower's slot, a frame with a bad MAC or out of sequence is
    refused, numpy payloads round-trip and nothing is unpickled, and a
    send that blocks raises ClusterError within its timeout.
"""

import hashlib
import hmac
import io
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.serving import multihost
from music_generator_tpu_torch.serving.server import (GenerationService,
                                                      serve_main)
from music_generator_tpu_torch.tools.mp_worker import serving_requests
from torch_mp_common import free_port, spawn

torch.set_num_threads(2)

SECRET = bytes(range(32))


def test_two_rank_service_answers_one_process_bytes(tmp_path):
    ranks = {}
    t = threading.Thread(target=lambda: ranks.update(out=spawn(
        str(tmp_path / "mp"), "serve", "--serve-port", free_port(),
        "--max-batch", 4, "--warmup-buckets", 1, "--batch-sizes", "4")))
    t.start()                       # the one-process service meanwhile
    cfg = port_test_config()
    service = GenerationService(
        config=cfg, params=build_model(cfg, "cpu", seed=0).state_dict(),
        device="cpu", max_batch=4, warmup_buckets=1)
    want = serving_requests(service, cfg, [4])
    t.join(timeout=300)
    (r0, _), (r1, _) = ranks["out"]
    assert set(r0["responses"]) == set(want)
    for k, v in want.items():
        assert bytes.fromhex(r0["responses"][k]) == v, k
        assert v[:4] == b"MThd"
    # Replayed: the solo job's begin, advance and drop, the batch, the
    # 16-bar job's begin, two advances and drop, the primed call.
    assert r1["replayed"] == 9
    # The warm-up's call and the requests' five.
    assert r0["device_calls"] == service.device_calls == 6
    assert r0["serve_launches"] == r1["serve_launches"] > 0


def test_follower_begin_failure_surfaces_on_advance():
    """A begin() that failed on a follower alone must not hide behind a
    KeyError: the leader's advance of that job fails with the original
    exception as its cause."""
    class FakeSampler:
        def begin(self, styles, **kw):
            raise ValueError("host-local failure during begin")

    class FakeService:
        _sampler = FakeSampler()

    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def leader():
        conn, _addr = srv.accept()
        multihost._accept_handshake(conn, SECRET)
        ch = multihost.Channel(conn, SECRET)
        ch.send(["begin", 7, [], {}])
        ch.send(["advance", 7, 1])
        try:                       # hold the socket open until the
            ch.recv()              # follower errors out and closes
        except Exception:
            pass

    t = threading.Thread(target=leader, daemon=True)
    t.start()
    try:
        with pytest.raises(RuntimeError, match="leader advanced job 7") as ei:
            multihost.follow(FakeService(), "127.0.0.1", port, SECRET,
                             timeout=10)
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        srv.close()
        t.join(timeout=5)
    assert not t.is_alive()


def test_serve_main_initializes_distributed(monkeypatch):
    """serve_main joins the process group before building anything (the
    lead / follow branch depends on it)."""
    calls = []

    def fake(device=None):
        calls.append(device)
        raise SystemExit(0)       # stop before building a real service

    monkeypatch.setattr(mesh, "maybe_init_distributed", fake)
    with pytest.raises(SystemExit):
        serve_main(["--port", "0", "--device", "cpu"])
    assert calls == ["cpu"]


def test_serve_main_needs_mp_coord_on_more_ranks(monkeypatch):
    monkeypatch.setattr(mesh, "maybe_init_distributed", lambda d=None: True)
    monkeypatch.setattr(mesh, "world", lambda: 2)
    with pytest.raises(SystemExit, match="--mp-coord"):
        serve_main(["--port", "0", "--device", "cpu"])


# -- the channel --------------------------------------------------------------

def test_numpy_payloads_round_trip_without_pickle(monkeypatch):
    import pickle
    monkeypatch.setattr(pickle, "loads", None)      # nothing may unpickle
    a, b = socket.socketpair()
    send, recv = multihost.Channel(a, SECRET), multihost.Channel(b, SECRET)
    msg = ["generate", [np.arange(6, dtype=np.float32).reshape(2, 3),
                        np.array([1, 2], np.uint8)],
           {"num_bars": 2, "seed": 7, "temperature": [1.0, 0.9],
            "prime": np.zeros((4, 5, 3), np.float32), "pad_to": None,
            "flag": True, "t": np.float32(0.9)}]
    for _ in range(3):                  # sequence numbers advance
        send.send(msg)
        got = recv.recv()
        assert got[0] == "generate"
        for x, y in zip(got[1], msg[1]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        prime = got[2].pop("prime")
        assert prime.dtype == np.float32 and prime.shape == (4, 5, 3)
        want = {k: v for k, v in msg[2].items() if k != "prime"}
        assert got[2] == {**want, "t": float(want["t"])}
    with pytest.raises(ValueError):                 # object arrays refused
        send.send(["x", np.array([object()], dtype=object)])
    a.close()
    b.close()


def _raw_frame(secret: bytes, seq: int, header: bytes, payload: bytes):
    mac = hmac.new(secret, struct.pack("<Q", seq) + header + payload,
                   hashlib.sha256).digest()
    return struct.pack("<QQ", len(header), len(payload)) + header \
        + payload + mac


@pytest.mark.parametrize("case", ["wrong-secret", "tampered", "replayed",
                                  "pickled-array"])
def test_bad_frames_are_refused(case):
    peer_a, peer_b = socket.socketpair()
    ch = multihost.Channel(peer_b, SECRET)
    header = json.dumps({"tree": ["stop"], "sizes": []}).encode()
    if case == "wrong-secret":
        peer_a.sendall(_raw_frame(b"x" * 32, 0, header, b""))
    elif case == "tampered":
        frame = bytearray(_raw_frame(SECRET, 0, header, b""))
        frame[20] ^= 1
        peer_a.sendall(bytes(frame))
    elif case == "replayed":
        frame = _raw_frame(SECRET, 0, header, b"")
        peer_a.sendall(frame + frame)
        assert ch.recv() == ["stop"]
    else:
        f = io.BytesIO()
        np.save(f, np.array([{"a": 1}], dtype=object), allow_pickle=True)
        blob = f.getvalue()
        head = json.dumps({"tree": [{"__nd__": 0}],
                           "sizes": [len(blob)]}).encode()
        peer_a.sendall(_raw_frame(SECRET, 0, head, blob))
    with pytest.raises(multihost.AuthenticationError if case != "pickled-array"
                       else ValueError):
        ch.recv()
    peer_a.close()
    peer_b.close()


def test_wrong_secret_takes_no_follower_slot():
    """lead() with one slot: an impostor connects first and is refused;
    the real follower then takes the slot and receives the stop."""
    port = free_port()

    class FakeService:
        _sampler = object()

    service = FakeService()
    result = {}

    def leader():
        result["proxy"] = multihost.lead(service, "127.0.0.1", port, 1,
                                         SECRET, timeout=30)

    t = threading.Thread(target=leader, daemon=True)
    t.start()
    impostor = None
    for _ in range(100):
        try:
            impostor = socket.create_connection(("127.0.0.1", port))
            break
        except OSError:
            time.sleep(0.05)
    multihost._answer_handshake(impostor, b"y" * 32)
    assert impostor.recv(1) == b""          # the leader hung up on it
    impostor.close()
    assert t.is_alive()                     # ... and still waits
    replayed = {}

    def follower():
        replayed["n"] = multihost.follow(FakeService(), "127.0.0.1", port,
                                         SECRET, timeout=30)

    f = threading.Thread(target=follower, daemon=True)
    f.start()
    t.join(timeout=30)
    assert not t.is_alive()
    proxy = result["proxy"]
    assert len(proxy._channels) == 1 and service._sampler is proxy
    proxy.stop_followers()
    f.join(timeout=30)
    assert not f.is_alive() and replayed["n"] == 0


def test_blocked_send_raises_within_its_timeout():
    """A follower that stops reading: the leader's sends fill the socket
    buffers, and the first that cannot finish within the timeout raises
    ClusterError; later calls raise at once."""
    a, b = socket.socketpair()
    a.settimeout(0.5)
    proxy = multihost._ReplaySampler(object(), [multihost.Channel(a,
                                                                  SECRET)])
    big = np.zeros(1 << 18, np.float32)
    t = time.monotonic()
    with pytest.raises(multihost.ClusterError, match="diverged"):
        for _ in range(1000):
            proxy._send(["generate", [big], {}])
    assert time.monotonic() - t < 20
    with pytest.raises(multihost.ClusterError, match="failed earlier"):
        proxy._send(["stop"])
    a.close()
    b.close()
