"""Generation serving on the card: a minimal HTTP service around the
port's streaming sampler (the JAX package's `serving/server.py`, with the
same API, scheduler and response bytes).

  * Power-of-two batch buckets: a batch of G requests runs padded to the
    next power of two, capped at `max_batch`, and always at full-length
    chunks (`pad_partial_chunk`; the surplus steps are sliced off), so the
    shapes the card sees stay few.  `warmup` runs every bucket once at
    start-up: the first call builds and loads the pitch-loop kernel
    (`csrc/notegen.cu`, nvcc) and makes the first cuBLAS and cuDNN calls,
    which no client request should pay with the execution lock held.
  * One device call at a time behind a lock; the stdlib
    ThreadingHTTPServer handles concurrent connections.  Whichever
    request thread wins the lock makes the call: the sampler's entry
    points run under `torch.no_grad` on that thread, and the service makes
    its device the current one.
  * Dynamic request coalescing: concurrent /generate requests that queue
    while the device is busy run as ONE batched device call.  Each piece
    is "stream 0 of its own seed at its own temperature" (the sampler's
    per-stream (seed, index, temperature) triples), so its bytes are
    those of the same request run alone.  A batch mixes only requests
    whose `bars` lie within `coalesce_bars_ratio` of each other, and the
    drain anchors on the SHORTEST pending request (a request skipped
    `coalesce_max_skips` times anchors regardless), so short interactive
    requests are not held behind long ones.  `dynamic_batch=False` /
    `--no-dynamic-batch` turns coalescing off.
  * Time slicing: a batch longer than `slice_bars` runs as a parked JOB
    whose recurrent state stays on the card between slice-sized device
    calls (`Sampler.begin` / `ActiveGeneration.advance`, the same notes as
    one call); new batches and parked jobs alternate passes, and a member
    finishes, and leaves the job's host buffers, as soon as its own bars
    are generated.
  * Bounded admission: at most `max_pending` coalesced requests, queued
    plus in flight; past that /generate answers 503 with Retry-After.

API:
  GET  /healthz                  -> {"status": "ok"}
  GET  /stats                    -> pending, active (in parked jobs),
                                    jobs, device_calls, max_pending,
                                    max_batch, slice_bars
  POST /generate                 -> audio/midi bytes
       {"styles": [0, 3],        # style indices to mix (mean of one-hots),
        "genre": 1,              # ...or a genre id (uniform mixture),
        "mixture": [..23 floats],# ...or an explicit mixture vector
        "bars": 16, "seed": 42, "temperature": 1.0,
        "prime_midi": "<b64>",   # optional: continue FROM this .mid
        "prime_bars": 8,         #   (teacher-forced primed continuation)
        "continuation_only": false}  # drop the echoed prime from the reply
  POST /generate_batch           -> {"files": [<b64 .mid>, ...]}
       {"mixtures": [[...], ...]} or {"styles_list": [[0, 3], [5]]}, plus
       the keys of /generate but the mixture ones; one device call.

Several cards: under `torchrun --nproc_per_node=N ... serve --mp-coord
HOST:PORT` (one process per card, parallel/mesh.py) every rank builds the
same service, the sampler spreads each batch's streams over the ranks,
rank 0 serves HTTP and every other rank replays its sampler calls from an
authenticated channel at --mp-coord (serving/multihost.py).  Without
torchrun the service runs on one card.  Weights come from `--from-keras`
(a reference Keras 2 model.h5) or `--params` (a keystr `.npz`), else
`out/model.pt`.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from music_generator_tpu_torch.config import Config, default_config
from music_generator_tpu_torch.data.dataset import (compute_genre,
                                                    decode_prime,
                                                    unclamp_midi)
from music_generator_tpu_torch.device import DeviceLike, resolve_device
from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                          prepend_prime)
from music_generator_tpu_torch.midi.codec import midi_encode
from music_generator_tpu_torch.midi.io import write_midifile
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.params import load_params_npz
from music_generator_tpu_torch.training.checkpoint import build_or_load
from music_generator_tpu_torch.training.keras_import import load_keras_weights
from music_generator_tpu_torch.utils import one_hot


class ServiceOverloaded(Exception):
    """The coalescing queue is at max_pending: the request was shed, not
    queued.  The HTTP handler maps this to 503 + Retry-After."""


class _Pending:
    """One enqueued /generate request awaiting a coalesced device call."""

    __slots__ = ("mixture", "bars", "seed", "temperature", "done", "result",
                 "error", "skips")

    def __init__(self, mixture, bars: int, seed: int, temperature: float):
        self.mixture = mixture
        self.bars = bars
        self.seed = seed
        self.temperature = temperature
        self.done = threading.Event()
        self.result: Optional[bytes] = None
        self.error: Optional[Exception] = None
        # Drain passes that selected a batch and left this request queued
        # (anti-starvation aging for shortest-group-first selection).
        self.skips = 0


class _Job:
    """An in-progress coalesced generation: the member requests, the
    parked incremental handle (Sampler.begin) whose state stays on the
    card between slices, and per member the host rows of the slices run
    so far (emptied once that member's result is encoded)."""

    __slots__ = ("batch", "gen", "bars_max", "bars_done", "parts")

    def __init__(self, batch, gen, bars_max: int):
        self.batch = batch
        self.gen = gen
        self.bars_max = bars_max
        self.bars_done = 0
        self.parts: list = [[] for _ in batch]


class GenerationService:
    """Model + sampler on one device, with a serialized-execution lock."""

    def __init__(self, config: Optional[Config] = None, params=None,
                 warmup: bool = True, max_batch: int = 64,
                 dynamic_batch: bool = True, max_pending: int = 256,
                 coalesce_bars_ratio: int = 4, coalesce_max_skips: int = 2,
                 slice_bars: int = 8,
                 warmup_buckets: Optional[int] = None,
                 device: DeviceLike = None):
        """`params`: a state dict (params.py: `params_from_numpy`,
        `load_params_npz`); None loads `out/model.pt` when a training run
        left one, else fresh weights (`build_or_load`).  `device`: the card
        unless "cpu" is asked for (a missing card raises)."""
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.dynamic_batch = bool(dynamic_batch)
        if int(max_pending) < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        # A coalesced batch generates to its longest request's bars, so
        # only requests within this ratio of each other share one (every
        # rider's discarded surplus <= (ratio-1)x its own bars).
        if int(coalesce_bars_ratio) < 1:
            raise ValueError(f"coalesce_bars_ratio must be >= 1, "
                             f"got {coalesce_bars_ratio}")
        self.coalesce_bars_ratio = int(coalesce_bars_ratio)
        if int(coalesce_max_skips) < 1:
            raise ValueError(f"coalesce_max_skips must be >= 1, "
                             f"got {coalesce_max_skips}")
        self.coalesce_max_skips = int(coalesce_max_skips)
        # A multiple of the sampler's 8-bar chunk, so a job's chunks are
        # those of the one-call path.
        if int(slice_bars) < 1 or int(slice_bars) % 8 != 0:
            raise ValueError(f"slice_bars must be a positive multiple of "
                             f"the 8-bar generation chunk, got {slice_bars}")
        self.slice_bars = int(slice_bars)
        self._jobs: list = []        # in-progress jobs, round-robin order
        self._job_turn = False       # alternate jobs vs new batches
        self._pending: list = []
        self._pending_lock = threading.Lock()
        # Coalesced requests selected into a batch or job and not yet done:
        # admission sheds on pending + active, so parked jobs cannot grow
        # past max_pending.  Guarded by _pending_lock.
        self._active = 0
        # Device calls made (coalescing shows as device_calls < requests).
        self.device_calls = 0
        self.cfg = config or default_config()
        self.device = resolve_device(device)
        if params is None:
            self.model, _ = build_or_load(self.cfg, self.device)
        else:
            self.model = build_model(self.cfg, self.device, state=params)
        self._lock = threading.Lock()
        # Coalesced requests: whether a thread is running scheduler passes
        # (the leader), and the condition the others wait on.
        self._turn = threading.Condition()
        self._leading = False
        # Serving returns .mid bytes only, so it takes the compact
        # velocity-byte transfer (config.py gen_compact_transfer: the same
        # .mid output, less to copy to the host).  A shallow copy of the
        # model shares its parameters; only the config differs.  One
        # sampler serves every temperature (a per-stream runtime input).
        gen_model = copy.copy(self.model)
        gen_model.cfg = self.cfg.replace(gen_compact_transfer=True)
        self._sampler = Sampler(gen_model)
        if warmup:
            self.warmup(warmup_buckets)

    def _on_device(self):
        """The context of every device call: the service's card as the
        current device of the calling thread (the sampler's entry points
        enter torch.no_grad themselves)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def warmup(self, max_bucket: Optional[int] = None) -> list:
        """Run every batch bucket once with a 1-bar request: bucket 1
        always; with `max_bucket`, every power-of-two bucket up to
        min(max_bucket, max_batch), plus max_batch itself as the top bucket
        when it isn't a power of two.  The first call builds and loads the
        pitch-loop kernel and makes the first cuBLAS and cuDNN calls.
        Prints the seconds it took; returns the bucket sizes run."""
        buckets = [1]
        if max_bucket:
            cap = min(int(max_bucket), self.max_batch)
            b = 2
            while b <= cap:
                buckets.append(b)
                b *= 2
            if int(max_bucket) >= self.max_batch \
                    and self.max_batch not in buckets:
                buckets.append(self.max_batch)
        started = time.perf_counter()
        base = compute_genre(0, self.cfg)
        for b in buckets:
            self.generate_batch([base] * b, bars=1)
        print(f"warmup: buckets {buckets} on {self.device} in "
              f"{time.perf_counter() - started:.1f} s", flush=True)
        return buckets

    def resolve_mixture(self, payload: dict) -> np.ndarray:
        cfg = self.cfg
        if "mixture" in payload:
            v = np.asarray(payload["mixture"], np.float32)
            if v.shape != (cfg.num_styles,):
                raise ValueError(
                    f"mixture must have {cfg.num_styles} entries")
            return v
        if "styles" in payload:
            idxs = payload["styles"]
            if not idxs or any(not 0 <= i < cfg.num_styles for i in idxs):
                raise ValueError(
                    f"style indices must be in [0, {cfg.num_styles})")
            return np.mean([one_hot(i, cfg.num_styles) for i in idxs], axis=0)
        genre = payload.get("genre", 0)
        if not 0 <= genre < len(cfg.genres):
            raise ValueError(f"genre must be in [0, {len(cfg.genres)})")
        return compute_genre(genre, cfg)

    def resolve_prime(self, payload: dict) -> Optional[np.ndarray]:
        """Decode an optional `prime_midi` (base64 .mid bytes) into a
        clamped roll for primed continuation; `prime_bars` truncates it.
        Invalid files raise ValueError (-> HTTP 400)."""
        b64 = payload.get("prime_midi")
        if b64 is None:
            return None
        try:
            raw = base64.b64decode(b64, validate=True)
        except Exception as e:
            raise ValueError(f"prime_midi is not valid base64: {e}")
        try:
            # Shared with the CLI's --prime: the parse guard, clamp,
            # prime_bars truncation and the 4096-bar length ceiling.
            return decode_prime(io.BytesIO(raw),
                                payload.get("prime_bars"), config=self.cfg)
        except ValueError as e:
            raise ValueError(f"prime_midi: {e}")

    def generate(self, mixture=None, bars: int = 8, seed: int = 0,
                 temperature: float = 1.0, prime=None,
                 continuation_only: bool = False) -> bytes:
        """Generate one piece and return .mid file bytes.  With dynamic
        batching on, concurrent non-primed requests coalesce into one
        device call; primed requests take the direct path."""
        if mixture is None:
            mixture = compute_genre(0, self.cfg)
        if self.dynamic_batch and prime is None:
            return self._coalesced(mixture, bars=bars, seed=seed,
                                   temperature=temperature)
        return self.generate_batch([mixture], bars=bars, seed=seed,
                                   temperature=temperature, prime=prime,
                                   continuation_only=continuation_only)[0]

    def _coalesced(self, mixture, bars: int, seed: int,
                   temperature: float) -> bytes:
        """Enqueue one request and run the leader/follower protocol: one
        thread at a time leads and runs scheduler passes over the whole
        queue; every other thread returns once some pass has finished its
        request.  Under sequential traffic the queue holds one request and
        this is the direct path plus one Event."""
        # Validate HERE, so a bad request fails its own caller before it
        # can reach a shared device call.
        bars = max(1, min(int(bars), 4096))
        temperature = float(temperature)
        if not 0.0 < temperature <= 100.0:
            raise ValueError("temperature must be in (0, 100]")
        seed = int(seed)
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must be in [0, 2**32), got {seed}")
        mixture = np.asarray(mixture, np.float32)
        if mixture.shape != (self.cfg.num_styles,):
            raise ValueError(
                f"mixture must have {self.cfg.num_styles} entries")
        req = _Pending(mixture, bars, seed, temperature)
        with self._pending_lock:
            in_flight = len(self._pending) + self._active
            if in_flight >= self.max_pending:
                raise ServiceOverloaded(
                    f"{in_flight} requests already in flight "
                    f"(max_pending={self.max_pending}); retry later")
            self._pending.append(req)
        # One thread at a time leads, running passes until its own request
        # is done; the others wait on _turn and return as soon as a pass
        # has finished theirs.  (Waiting on the execution lock instead
        # would hold a finished request until the leader let go of the
        # lock: a thread that releases a lock and takes it again at once
        # usually wins it, so a short request could wait for a whole long
        # job.)
        while True:
            with self._turn:
                while self._leading and not req.done.is_set():
                    self._turn.wait()
                if req.done.is_set():
                    break
                self._leading = True
            try:
                with self._lock:
                    self._run_pending_locked()
            finally:
                with self._turn:
                    self._leading = False
                    self._turn.notify_all()
        if req.error is not None:
            raise req.error
        return req.result

    def _bucket(self, G: int) -> int:
        """Power-of-two bucket for a batch of G (capped at max_batch, which
        joins as the top bucket when not a power of two)."""
        bucket = 1
        while bucket < G:
            bucket *= 2
        return min(bucket, self.max_batch)

    def _encode_midi(self, roll: np.ndarray) -> bytes:
        pattern = midi_encode(unclamp_midi(roll, self.cfg), config=self.cfg)
        buf = io.BytesIO()
        write_midifile(buf, pattern)
        return buf.getvalue()

    def _run_pending_locked(self) -> None:
        """One scheduler pass: start a new coalesced batch OR advance one
        parked job by one slice.  Caller must hold self._lock.

        New batches and parked jobs alternate passes and jobs round-robin
        among themselves, so a short request waits at most for the slice
        in flight plus one scheduling round.  Selection anchors on the
        shortest pending request (FIFO tiebreak; an aged request anchors
        regardless) and adds others in arrival order while
        max(bars)/min(bars) stays within coalesce_bars_ratio."""
        with self._pending_lock:
            have_pending = bool(self._pending)
        if self._jobs and (self._job_turn or not have_pending):
            job = self._jobs.pop(0)
            self._advance_job(job)
            if job.bars_done < job.bars_max:
                self._jobs.append(job)     # round-robin among jobs
            self._job_turn = False
            return
        batch = self._select_batch()
        if not batch:
            return
        self._start_job(batch)
        # Parked jobs get the next pass, so a stream of fresh arrivals
        # can't starve in-progress pieces (and vice versa).
        self._job_turn = bool(self._jobs)

    def _select_batch(self) -> list:
        """Pop the next coalescable batch off the pending queue (see
        _run_pending_locked for the policy)."""
        ratio = self.coalesce_bars_ratio
        with self._pending_lock:
            if not self._pending:
                return []
            aged = [r for r in self._pending
                    if r.skips >= self.coalesce_max_skips]
            anchor = aged[0] if aged else min(self._pending,
                                              key=lambda r: r.bars)
            batch, rest = [anchor], []
            lo = hi = anchor.bars
            for r in self._pending:
                if r is anchor:
                    continue
                nlo, nhi = min(lo, r.bars), max(hi, r.bars)
                fits_ratio = nhi <= ratio * nlo
                if len(batch) < self.max_batch and fits_ratio:
                    batch.append(r)
                    lo, hi = nlo, nhi
                    continue
                if not fits_ratio:
                    # Only bars-ratio rejections age, also when the batch
                    # is full (at max_batch=1 every pass fills at once, and
                    # a long request must still age); pure capacity skips
                    # are backpressure and would collapse the policy into
                    # FIFO under load.
                    r.skips += 1
                rest.append(r)
            self._pending = rest
            self._active += len(batch)
        return batch

    def _retire(self, n: int) -> None:
        """Release n coalesced requests from the in-flight admission count
        (every request selected by _select_batch is retired exactly once,
        at whichever point sets its done event)."""
        if n:
            with self._pending_lock:
                self._active -= n

    def _start_job(self, batch: list) -> None:
        """Open the incremental generation for a batch and run its first
        slice.  Every coalesced piece is stream 0 of its seed at its
        temperature (the solo /generate identity), generated to the longest
        member's bars and cut to its own."""
        try:
            with self._on_device():
                gen = self._sampler.begin(
                    [r.mixture for r in batch],
                    seeds=[r.seed for r in batch],
                    stream_indices=[0] * len(batch),
                    temperature=[r.temperature for r in batch],
                    pad_to=self._bucket(len(batch)))
        except Exception as e:
            for r in batch:
                if r.result is None and r.error is None:
                    r.error = e
                r.done.set()
            self._retire(len(batch))
            return
        job = _Job(batch, gen, bars_max=max(r.bars for r in batch))
        self._advance_job(job)
        if job.bars_done < job.bars_max:
            self._jobs.append(job)

    def _advance_job(self, job: _Job) -> None:
        """Run one slice_bars slice of a job; finalize the members whose
        own bars are complete (a short member never waits for its longest
        co-member), and drop their rows from the job."""
        spb = self.cfg.notes_per_bar
        try:
            with self._on_device():
                notes = job.gen.advance(self.slice_bars // 8)
            self.device_calls += 1
            job.bars_done += self.slice_bars
        except Exception as e:
            # A failed device call fails the job, but only members that
            # have no result or error of their own yet.
            job.bars_done = job.bars_max      # don't requeue
            self._finalize_job(job)
            n_new = sum(1 for r in job.batch if not r.done.is_set())
            for r in job.batch:
                if r.result is None and r.error is None:
                    r.error = e
                r.done.set()
            self._retire(n_new)
            return
        finished = job.bars_done >= job.bars_max
        n_new = 0
        for i, r in enumerate(job.batch):
            if r.done.is_set():
                continue
            if finished or r.bars <= job.bars_done:
                # Per-request encode: one bad roll must not poison its
                # siblings' results.
                try:
                    roll = np.concatenate(job.parts[i] + [notes[i]], axis=0)
                    r.result = self._encode_midi(roll[:r.bars * spb])
                except Exception as e:    # noqa: BLE001 — per-request fate
                    r.error = e
                job.parts[i] = []
                r.done.set()
                n_new += 1
            else:
                # A copy, so the slice's array (every member's rows) goes.
                job.parts[i].append(notes[i].copy())
        self._retire(n_new)
        if finished:
            self._finalize_job(job)

    @staticmethod
    def _finalize_job(job: _Job) -> None:
        """Close the job's handle, freeing its state on the card, and
        release the host rows.  Best-effort on both the failure and the
        finished path: a failing close must not turn results already
        delivered into an exception on the serving thread."""
        close = getattr(job.gen, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
        job.parts.clear()

    def generate_batch(self, mixtures, bars: int = 8, seed: int = 0,
                       temperature: float = 1.0, prime=None,
                       continuation_only: bool = False) -> list:
        """Generate one piece per style mixture in ONE device call and
        return a list of .mid byte strings.  A piece's bytes depend on
        (weights, seed, bars, temperature, index) alone, not on the bucket
        it is padded to or on what else rides in the request."""
        if not mixtures or len(mixtures) > self.max_batch:
            raise ValueError(f"1..{self.max_batch} mixtures per request")
        bars = max(1, min(int(bars), 4096))
        temperature = float(temperature)
        if not 0.0 < temperature <= 100.0:
            raise ValueError("temperature must be in (0, 100]")
        styles = [np.asarray(m, np.float32) for m in mixtures]
        G = len(styles)
        with self._lock, self._on_device():
            result = self._sampler.generate(styles, num_bars=bars,
                                            seed=int(seed),
                                            temperature=temperature,
                                            prime=prime,
                                            pad_to=self._bucket(G),
                                            pad_partial_chunk=True)
            self.device_calls += 1
        notes = result.notes
        if (prime is not None and prime.shape[0] > 0
                and not continuation_only):
            # Default primed response = prime + continuation, like the CLI.
            notes = prepend_prime(notes, prime)
        return [self._encode_midi(notes[i]) for i in range(G)]


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        # Socket timeout for request reads (incl. the bounded 413 drain):
        # a stalled client must not pin a handler thread forever.
        timeout = 120

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                # Snapshot reads under the pending lock; device_calls is a
                # monotone counter.
                with service._pending_lock:
                    pending = len(service._pending)
                    active = service._active
                self._json(200, {
                    "pending": pending,
                    "active": active,
                    "jobs": len(service._jobs),
                    "device_calls": service.device_calls,
                    "max_pending": service.max_pending,
                    "max_batch": service.max_batch,
                    "slice_bars": service.slice_bars,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/generate", "/generate_batch"):
                self._json(404, {"error": "unknown path"})
                return
            if self.headers.get("Transfer-Encoding"):
                # A chunked body would read as length 0 (a 200 with
                # default parameters) and its unread frames would corrupt
                # the keep-alive stream.  411 = length required.
                self._json(411, {"error": "Transfer-Encoding not "
                                          "supported; send Content-Length"})
                self.close_connection = True
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                # 1 MB is plenty for 64 mixtures; a negative length must
                # not fall through to read(-1), an unbounded read.
                if not 0 <= length <= (1 << 20):
                    self._json(413, {"error": "request body too large"})
                    # Drain a bounded amount so a mid-send client reads the
                    # 413 instead of a connection reset; give up past 8 MB.
                    try:
                        remaining = min(max(length, 0), 8 << 20)
                        while remaining > 0:
                            chunk = self.rfile.read(min(65536, remaining))
                            if not chunk:
                                break
                            remaining -= len(chunk)
                    except OSError:
                        pass
                    self.close_connection = True
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                options = dict(
                    bars=payload.get("bars", 8),
                    seed=payload.get("seed", 0),
                    temperature=payload.get("temperature", 1.0),
                    prime=service.resolve_prime(payload),
                    continuation_only=bool(
                        payload.get("continuation_only", False)))
                if self.path == "/generate_batch":
                    if "mixtures" in payload:
                        mixtures = [service.resolve_mixture({"mixture": m})
                                    for m in payload["mixtures"]]
                    else:
                        mixtures = [service.resolve_mixture({"styles": s})
                                    for s in payload.get("styles_list", [])]
                    files = service.generate_batch(mixtures, **options)
                    self._json(200, {"files": [
                        base64.b64encode(f).decode() for f in files]})
                    return
                midi_bytes = service.generate(
                    mixture=service.resolve_mixture(payload), **options)
            except ServiceOverloaded as e:
                # Load shed: the coalescing queue is full.
                self._json(503, {"error": str(e)}, [("Retry-After", "1")])
                return
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/midi")
            self.send_header("Content-Length", str(len(midi_bytes)))
            self.end_headers()
            self.wfile.write(midi_bytes)

    return Handler


class DeepJHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty traffic:
    the stdlib default (5) resets connections when more than a handful of
    clients connect at once, the coalescing workload's shape.  Admission
    control proper happens at max_pending (HTTP 503)."""
    request_queue_size = 128
    daemon_threads = True


def serve_main(argv=None) -> None:
    """`python -m music_generator_tpu_torch.serve`: serve on the card (or
    on the CPU with --device cpu) until interrupted.  The JAX service's
    flags plus --params and --device.  Under torchrun every rank runs the
    same command: rank 0 serves HTTP and leads the replay channel at
    --mp-coord, the others follow it until rank 0 stops."""
    from music_generator_tpu_torch.cli import _device_flag, _join
    parser = argparse.ArgumentParser(description="DeepJ generation server.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8732)
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--params", type=str, default=None, metavar="NPZ",
                         help="Weights as a keystr-layout .npz (e.g. "
                              "artifacts/trained_model_r4/params.npz; not "
                              "with --from-keras); without either "
                              "out/model.pt when a training run left one, "
                              "else fresh weights")
    weights.add_argument("--from-keras", type=str, default=None,
                         metavar="MODEL_H5",
                         help="Serve a reference (Keras 2) model.h5's "
                              "weights (not with --params)")
    parser.add_argument("--keras2-gates", action="store_true",
                        help="Keras 2 hard_sigmoid LSTM gates for "
                             "reference-trained weights (deviation #12)")
    parser.add_argument("--max-batch", type=int, default=64,
                        help="largest /generate_batch request and coalesced "
                             "batch (batches run padded to power-of-two "
                             "buckets up to it)")
    parser.add_argument("--no-dynamic-batch", action="store_true",
                        help="disable coalescing of concurrent /generate "
                             "requests into one device call (responses "
                             "are the same bytes either way)")
    parser.add_argument("--warmup-buckets", type=int, default=None,
                        metavar="N",
                        help="run every power-of-two batch bucket up to N "
                             "once at start-up (default: all up to "
                             "--max-batch; pass 1 for the fastest start)")
    parser.add_argument("--max-pending", type=int, default=256,
                        help="coalescing-queue depth: /generate requests "
                             "past this shed with HTTP 503")
    parser.add_argument("--coalesce-bars-ratio", type=int, default=4,
                        help="only coalesce /generate requests whose bars "
                             "are within this ratio of each other (1 = "
                             "never mix bars)")
    parser.add_argument("--coalesce-max-skips", type=int, default=2,
                        help="a request skipped by this many drain passes "
                             "anchors the next batch regardless of its bars")
    parser.add_argument("--slice-bars", type=int, default=8,
                        help="time-slice size for long generations "
                             "(a multiple of the 8-bar chunk)")
    parser.add_argument("--mp-coord", type=str, default=None,
                        metavar="HOST:PORT",
                        help="the replay channel across ranks: rank 0 binds "
                             "here and serves HTTP, every other rank "
                             "connects and replays its sampler calls "
                             "(required under torchrun with more than one "
                             "rank; the same flags on every rank; a "
                             "cluster-internal address)")
    _device_flag(parser, "serve")
    args = parser.parse_args(argv)

    # Join the process group before anything touches the card.
    device = _join(args.device)
    if mesh.world() > 1 and not args.mp_coord:
        raise SystemExit("serving on more than one rank needs --mp-coord "
                         "HOST:PORT (the leader's replay-channel address; "
                         "the same flag on every rank)")
    cfg = default_config()
    if args.keras2_gates:
        cfg = cfg.replace(lstm_recurrent_activation="hard_sigmoid")
    params = None
    if args.from_keras:
        params = load_keras_weights(args.from_keras, cfg)
        print(f"Loaded Keras weights from {args.from_keras}")
    elif args.params:
        params = load_params_npz(args.params)
        print(f"Loaded weights from {args.params}")
    warmup_buckets = (args.warmup_buckets if args.warmup_buckets is not None
                      else args.max_batch)
    service = GenerationService(config=cfg, params=params, device=device,
                                max_batch=args.max_batch,
                                dynamic_batch=not args.no_dynamic_batch,
                                max_pending=args.max_pending,
                                coalesce_bars_ratio=args.coalesce_bars_ratio,
                                coalesce_max_skips=args.coalesce_max_skips,
                                slice_bars=args.slice_bars,
                                warmup_buckets=warmup_buckets)
    proxy = None
    if mesh.world() > 1:
        # Every rank built the same service (the same flags give the same
        # warm-up calls); from here rank 0 replays each sampler call.
        from music_generator_tpu_torch.serving.multihost import (
            follow, lead, shared_secret)
        mp_host, mp_port = args.mp_coord.rsplit(":", 1)
        secret = shared_secret()
        if mesh.rank() != 0:
            print(f"follower {mesh.rank()}: replaying the leader's sampler "
                  f"calls from {args.mp_coord}", flush=True)
            n = follow(service, mp_host, int(mp_port), secret)
            print(f"follower {mesh.rank()}: leader closed after {n} calls",
                  flush=True)
            return
        proxy = lead(service, mp_host, int(mp_port), mesh.world() - 1,
                     secret)
    httpd = DeepJHTTPServer((args.host, args.port), make_handler(service))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"serving on http://{args.host}:{httpd.server_port} ({where})",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if proxy is not None:
            proxy.stop_followers()
