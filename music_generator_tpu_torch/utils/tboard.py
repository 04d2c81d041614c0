"""Minimal TensorBoard event-file writer (scalars + histograms): the port's
own copy of the JAX package's pure-Python `utils/tboard.py`.

The reference logs scalars AND weight histograms to TensorBoard via Keras
(ref: train.py:25, histogram_freq=1).  No tensorflow/tensorboard package is
needed: this module hand-rolls the formats involved — the TFRecord framing
(length + masked CRC32C) and the subset of the `Event`/`Summary`/
`HistogramProto` protobufs needed for scalar curves and histogram panes.
Files written here load in stock TensorBoard (its data_compat layer
migrates legacy `Summary.Value.histo` records into the histograms plugin).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional


# --- CRC32C (Castagnoli), table-driven --------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- Tiny protobuf encoder ---------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # Python's arithmetic right-shift never zeroes a negative int —
        # the loop below would spin forever.  No in-repo caller passes
        # negatives (steps/lengths/field keys); fail loudly if one appears.
        raise ValueError(f"varint requires a non-negative int, got {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _scalar_event(step: int, tag: str, value: float,
                  wall_time: Optional[float] = None) -> bytes:
    summary_value = _field_bytes(1, tag.encode()) + _field_float(2, value)
    summary = _field_bytes(1, summary_value)
    return (_field_double(1, wall_time or time.time())
            + _field_varint(2, step)
            + _field_bytes(5, summary))


def _packed_doubles(num: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _histogram_proto(values) -> bytes:
    """HistogramProto wire bytes for a flat sequence of floats.

    Fields (tensorflow/core/framework/summary.proto): min=1, max=2, num=3,
    sum=4, sum_squares=5, bucket_limit=6 (packed), bucket=7 (packed).
    Buckets are 30 equal-width bins over [min, max] — TensorBoard re-buckets
    for display, so the exact limits only need to be well-formed."""
    import numpy as np   # deferred: scalar-only users stay numpy-free
    vals = np.asarray(values, dtype=np.float64).ravel()
    # Diverged training produces NaN/inf params; the histogram must keep
    # logging (so the run can report the divergence), never crash fit().
    vals = vals[np.isfinite(vals)]
    n = int(vals.size)
    if n == 0:
        return (_field_double(1, 0.0) + _field_double(2, 0.0)
                + _field_double(3, 0.0) + _field_double(4, 0.0)
                + _field_double(5, 0.0)
                + _packed_doubles(6, [1.0]) + _packed_doubles(7, [0.0]))
    lo, hi = float(vals.min()), float(vals.max())
    total = float(vals.sum())
    sq = float(np.square(vals).sum())
    if lo == hi:
        limits = [hi if hi > 0 else hi + 1e-12, float("inf")]
        counts = [float(n), 0.0]
    else:
        counts_arr, edges = np.histogram(vals, bins=30, range=(lo, hi))
        counts = counts_arr.astype(np.float64).tolist()
        limits = edges[1:].tolist()
    return (_field_double(1, lo) + _field_double(2, hi)
            + _field_double(3, float(n)) + _field_double(4, total)
            + _field_double(5, sq)
            + _packed_doubles(6, limits) + _packed_doubles(7, counts))


def _histo_event(step: int, tag: str, values,
                 wall_time: Optional[float] = None) -> bytes:
    # Summary.Value field 5 = histo (field 4 is image — verified against
    # TF's summary.proto descriptors).
    summary_value = (_field_bytes(1, tag.encode())
                     + _field_bytes(5, _histogram_proto(values)))
    summary = _field_bytes(1, summary_value)
    return (_field_double(1, wall_time or time.time())
            + _field_varint(2, step)
            + _field_bytes(5, summary))


def _version_event() -> bytes:
    return (_field_double(1, time.time())
            + _field_bytes(3, b"brain.Event:2"))


class SummaryWriter:
    """Append-only scalar/histogram event writer; one file per run dir."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write_record(_version_event())

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_scalar_event(step, tag, float(value)))

    def histogram(self, tag: str, values, step: int) -> None:
        """Write a histogram of `values` (any array-like), visible in stock
        TensorBoard's histograms tab (ref: train.py:25 histogram_freq=1)."""
        self._write_record(_histo_event(step, tag, values))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
