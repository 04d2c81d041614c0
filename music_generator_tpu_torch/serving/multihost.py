"""Serving across ranks: one HTTP front end, every rank's card generating
(the JAX package's `serving/multihost.py`).

In a process group (parallel/mesh.py, one process per card) every sampler
call is collective: each rank runs its block of the streams and the notes
are all-gathered, so every rank must make the same call or the group
waits for ever.  HTTP requests reach rank 0 only.  So rank 0 (the LEADER)
serves HTTP as the one-process service does, and `lead()` wraps its
sampler so that every `generate()`, and every time-sliced job's
`begin()` / `advance()` / `close()`, first ships its arguments to every
other rank (the FOLLOWERS) over a TCP replay channel and then runs.  All
sampler calls already run one at a time under the service's execution
lock, so the replay order is the execution order.  A follower builds the
same service (the same flags give the same warm-up calls, so warm-up needs
no channel) and sits in `follow()`, replaying each call into its sampler.
Responses are the one-process service's bytes: stream-indexed uniforms.

The channel differs from the JAX package's in three ways:
  * no pickle: a frame is a JSON header and raw numpy buffers, each read
    back by `np.load(allow_pickle=False)`;
  * authentication: rank 0 draws a 32-byte secret and broadcasts it over
    the process group (`shared_secret`); the leader accepts a connection
    only once it has answered a fresh nonce with HMAC-SHA256(secret,
    nonce), and a connection that fails takes no follower's slot; every
    frame carries an HMAC over its sequence number and bytes, and a frame
    whose MAC or sequence number is wrong is refused;
  * a send timeout: the leader's sends, made while it holds the service
    lock, time out after `send_timeout` seconds and raise ClusterError,
    after which every replayed call raises too (the ranks have diverged).
"""

from __future__ import annotations

import hashlib
import hmac
import io
import json
import os
import socket
import struct
import sys
import threading
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np

from music_generator_tpu_torch.parallel import mesh

SECRET_BYTES = 32
_MAC = hashlib.sha256
_MAC_BYTES = 32
_HEAD = struct.Struct("<QQ")          # header bytes, payload bytes
_MAX_FRAME = 1 << 31


class ClusterError(RuntimeError):
    """The replay channel failed (a send timed out or a peer went away):
    the ranks no longer make the same calls, so the service cannot go on."""


class AuthenticationError(ConnectionError):
    """A peer failed the handshake, or a frame's MAC or sequence number
    was wrong."""


def shared_secret() -> bytes:
    """Rank 0's fresh 32-byte secret, broadcast over the process group
    (a collective: every rank calls it)."""
    mine = os.urandom(SECRET_BYTES) if mesh.rank() == 0 else None
    return mesh.broadcast_bytes(mine, SECRET_BYTES)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("replay channel closed")
        buf.extend(chunk)
    return bytes(buf)


def _encode(obj, buffers: list):
    """JSON-able form of a frame's object: numpy arrays become references
    into `buffers`, tuples lists, numpy scalars Python scalars."""
    if isinstance(obj, np.ndarray):
        buffers.append(obj)
        return {"__nd__": len(buffers) - 1}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [_encode(v, buffers) for v in obj]
    if isinstance(obj, dict):
        if any(not isinstance(k, str) for k in obj) or "__nd__" in obj:
            raise TypeError("frame dicts take str keys other than __nd__")
        return {k: _encode(v, buffers) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot send a {type(obj).__name__} over the channel")


def _decode(obj, arrays: list):
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            return arrays[obj["__nd__"]]
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


class Channel:
    """Authenticated frames over a connected socket: a JSON header and the
    numpy buffers it references (.npy format, loaded without pickle),
    each frame followed by HMAC-SHA256(secret, seq || header || payload)."""

    def __init__(self, sock: socket.socket, secret: bytes):
        self._sock = sock
        self._secret = secret
        self._send_seq = 0
        self._recv_seq = 0

    def _mac(self, seq: int, *parts: bytes) -> bytes:
        m = hmac.new(self._secret, struct.pack("<Q", seq), _MAC)
        for p in parts:
            m.update(p)
        return m.digest()

    def send(self, obj) -> None:
        buffers: list = []
        tree = _encode(obj, buffers)
        blobs = []
        for a in buffers:
            f = io.BytesIO()
            np.save(f, np.ascontiguousarray(a), allow_pickle=False)
            blobs.append(f.getvalue())
        header = json.dumps({"tree": tree,
                             "sizes": [len(b) for b in blobs]}).encode()
        payload = b"".join(blobs)
        mac = self._mac(self._send_seq, header, payload)
        self._sock.sendall(_HEAD.pack(len(header), len(payload)) + header
                           + payload + mac)
        self._send_seq += 1

    def recv(self):
        n_head, n_pay = _HEAD.unpack(_recv_exact(self._sock, _HEAD.size))
        if n_head + n_pay > _MAX_FRAME:
            raise AuthenticationError(f"frame of {n_head + n_pay} bytes")
        header = _recv_exact(self._sock, n_head)
        payload = _recv_exact(self._sock, n_pay)
        mac = _recv_exact(self._sock, _MAC_BYTES)
        if not hmac.compare_digest(
                mac, self._mac(self._recv_seq, header, payload)):
            raise AuthenticationError(
                f"frame {self._recv_seq}: bad MAC (wrong secret, a "
                f"tampered frame or one out of sequence)")
        self._recv_seq += 1
        meta = json.loads(header)
        arrays, at = [], 0
        for size in meta["sizes"]:
            arrays.append(np.load(io.BytesIO(payload[at:at + size]),
                                  allow_pickle=False))
            at += size
        return _decode(meta["tree"], arrays)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def _accept_handshake(conn: socket.socket, secret: bytes) -> None:
    """Leader side: send a fresh nonce, require its HMAC back."""
    nonce = os.urandom(SECRET_BYTES)
    conn.sendall(nonce)
    answer = _recv_exact(conn, _MAC_BYTES)
    if not hmac.compare_digest(answer,
                               hmac.new(secret, nonce, _MAC).digest()):
        raise AuthenticationError("peer does not hold the cluster secret")


def _answer_handshake(sock: socket.socket, secret: bytes) -> None:
    """Follower side: answer the leader's nonce."""
    nonce = _recv_exact(sock, SECRET_BYTES)
    sock.sendall(hmac.new(secret, nonce, _MAC).digest())


class _ReplaySampler:
    """Leader-side sampler wrapper: ship each generate() / begin() to the
    followers, then run it locally.  Attribute reads fall through to the
    real sampler (the service reads `.cfg` and friends)."""

    def __init__(self, sampler, channels: Sequence[Channel]):
        self._real = sampler
        self._channels: List[Channel] = list(channels)
        self._send_lock = threading.Lock()
        self._next_job = 0
        self._broken: Optional[Exception] = None

    def __getattr__(self, name):
        return getattr(self._real, name)

    def _send(self, payload) -> None:
        with self._send_lock:
            if self._broken is not None:
                raise ClusterError("the replay channel failed earlier; the "
                                   "ranks have diverged") from self._broken
            try:
                for ch in self._channels:
                    ch.send(payload)
            except (OSError, ConnectionError) as e:
                # socket.timeout is an OSError: a follower that stopped
                # reading.  A frame went to some followers and not others.
                self._broken = e
                raise ClusterError(f"replay send failed ({type(e).__name__}"
                                   f": {e}); the ranks have diverged") from e

    def generate(self, styles, **kwargs):
        self._send(["generate", [np.asarray(s, np.float32) for s in styles],
                    kwargs])
        return self._real.generate(styles, **kwargs)

    def begin(self, styles, **kwargs):
        """Open a time-sliced job on every rank: the followers park the
        same state and replay each advance under the same job id."""
        with self._send_lock:
            job_id = self._next_job
            self._next_job += 1
        self._send(["begin", job_id,
                    [np.asarray(s, np.float32) for s in styles], kwargs])
        try:
            real = self._real.begin(styles, **kwargs)
        except Exception:
            # The frame went out: drop the job so no follower keeps a
            # handle the leader never opened (a validation failure raised
            # on the followers too, where the drop is a no-op).
            self._send(["drop", job_id])
            raise
        return _ReplayActive(self, job_id, real)

    def stop_followers(self) -> None:
        with self._send_lock:
            for ch in self._channels:
                try:
                    ch.send(["stop"])
                except (OSError, ConnectionError):
                    pass
                ch.close()


class _ReplayActive:
    """Leader-side ActiveGeneration wrapper: ship each advance() / close()
    under the job id begin() assigned, then run it locally."""

    def __init__(self, proxy: _ReplaySampler, job_id: int, real):
        self._proxy = proxy
        self._job_id = job_id
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def advance(self, num_chunks: int = 1):
        self._proxy._send(["advance", self._job_id, int(num_chunks)])
        return self._real.advance(num_chunks)

    def close(self) -> None:
        self._proxy._send(["drop", self._job_id])
        self._real.close()


def lead(service, host: str, port: int, n_followers: int, secret: bytes,
         timeout: float = 300.0, send_timeout: float = 60.0
         ) -> _ReplaySampler:
    """Bind the replay channel, accept `n_followers` authenticated
    followers within `timeout` seconds (a connection that fails the
    handshake is closed and takes no slot), and swap the service's sampler
    for the replaying wrapper.  Returns the wrapper (call
    `.stop_followers()` on shutdown)."""
    deadline = time.monotonic() + timeout
    srv = socket.create_server((host, port))
    channels: List[Channel] = []
    try:
        while len(channels) < n_followers:
            left = deadline - time.monotonic()
            if left <= 0:
                raise ClusterError(f"{len(channels)} of {n_followers} "
                                   f"followers joined in {timeout} s")
            srv.settimeout(left)
            try:
                conn, addr = srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(min(10.0, left))
            try:
                _accept_handshake(conn, secret)
            except (OSError, ConnectionError) as e:
                print(f"replay channel: refused {addr[0]}:{addr[1]} "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
                conn.close()
                continue
            conn.settimeout(send_timeout)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            channels.append(Channel(conn, secret))
    except BaseException:
        for ch in channels:
            ch.close()
        raise
    finally:
        srv.close()
    proxy = _ReplaySampler(service._sampler, channels)
    service._sampler = proxy
    return proxy


def follow(service, host: str, port: int, secret: bytes,
           timeout: float = 300.0) -> int:
    """Connect to the leader, answer its handshake and replay its sampler
    calls until it says stop or the channel closes.  Returns the number
    of calls replayed."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    ch = Channel(sock, secret)
    replayed = 0
    actives = {}      # job id -> this rank's parked ActiveGeneration
    failed = {}       # job id -> the exception this rank's begin raised
    try:
        _answer_handshake(sock, secret)
        sock.settimeout(None)
        while True:
            try:
                msg = ch.recv()
            except AuthenticationError:
                raise
            except ConnectionError:
                break                      # the leader went away
            kind = msg[0]
            if kind == "stop":
                break
            if kind == "generate":
                _, styles, kwargs = msg
                try:
                    service._sampler.generate(list(styles), **kwargs)
                except Exception:
                    # A validation failure raises on the leader too, which
                    # answers the request with it; the follower goes on.
                    pass
            elif kind == "begin":
                _, job_id, styles, kwargs = msg
                try:
                    actives[job_id] = service._sampler.begin(list(styles),
                                                             **kwargs)
                except Exception as e:
                    # The leader's begin raised too (and sends a drop), or
                    # this rank failed alone: then an advance of the job
                    # must fail with this cause, not a KeyError.
                    failed[job_id] = e
                    traceback.print_exc(file=sys.stderr)
            elif kind == "advance":
                _, job_id, num_chunks = msg
                if job_id in failed:
                    raise RuntimeError(
                        f"leader advanced job {job_id} whose begin failed "
                        f"on this follower (leader and follower state "
                        f"have diverged)") from failed[job_id]
                actives[job_id].advance(num_chunks)
            elif kind == "drop":
                failed.pop(msg[1], None)
                gen = actives.pop(msg[1], None)
                if gen is not None:
                    gen.close()
            else:
                raise ValueError(f"unknown replay verb: {kind!r}")
            replayed += 1
    finally:
        ch.close()
    return replayed
