"""ctypes bindings for the native C++ MIDI decoder (`native/midi_codec.cc`),
the counterpart of the JAX package's `midi/native.py`: the same C ABI
(`dj_decode_file`, `dj_decode_buffer`, `dj_free`, `dj_abi_version() == 1`)
and the same results, bit for bit, as the Python codec.  It decodes outside
the GIL, so the corpus loader's threads decode in parallel.

The library is built from the source in the checkout with the system C++
compiler ($CXX, else g++ or c++) and the flags of `native/Makefile`:

    g++ -O3 -std=c++17 -fPIC -shared \
        -o build/torch_native/libdeepj_midi-<hash>.so native/midi_codec.cc

The file name carries a hash of the source and the flags, so an edited
source rebuilds.  The build happens at the first `available()` or decode,
never on import, under the `fcntl` lock of ops/_build.py, so the ranks of
one machine build once.  `DEEPJ_MIDI_LIB`, where set to an existing file,
names a library to load instead, as in the JAX package.  Where no compiler
exists or the build fails, `available()` is False (the reason is printed
once), the decoders raise ImportError and `load_midi` takes the Python
path."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from music_generator_tpu_torch.ops._build import build_lock

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "midi_codec.cc"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_WHY = ""
_lock = threading.Lock()


def compiler() -> Optional[str]:
    """$CXX, else g++ or c++ on PATH; None when there is none."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def library_path() -> Path:
    """build/torch_native/libdeepj_midi-<hash of source and flags>.so"""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdeepj_midi-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError without a compiler or with the compiler's output."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++) on PATH")
    lib = library_path()
    with build_lock(BUILD_DIR):
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
    return lib


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    out_t = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
    lib.dj_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, out_t,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.dj_decode_file.restype = ctypes.c_int
    lib.dj_decode_buffer.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_int, ctypes.c_int, out_t,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.dj_decode_buffer.restype = ctypes.c_int
    lib.dj_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.dj_abi_version.restype = ctypes.c_int
    if lib.dj_abi_version() != 1:
        raise RuntimeError(f"{path}: dj_abi_version() is "
                           f"{lib.dj_abi_version()}, not 1")
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _WHY
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        env = os.environ.get("DEEPJ_MIDI_LIB", "")
        try:
            path = env if env and os.path.exists(env) else str(build())
            _LIB = _bind(path)
        except (OSError, RuntimeError) as e:
            _WHY = str(e)
            print(f"native MIDI decoder unavailable, decoding in Python: "
                  f"{_WHY}", file=sys.stderr)
        return _LIB


def available() -> bool:
    """Whether the native decoder loads (building it on first call)."""
    return _load() is not None


def why_unavailable() -> str:
    """The reason `available()` is False ("" when it is True)."""
    _load()
    return _WHY


def _roll(lib, out, frames) -> np.ndarray:
    try:
        n = frames.value
        if n == 0 or not out:
            return np.zeros((0, 128, 3))
        return np.ctypeslib.as_array(out, shape=(n, 128, 3)).copy()
    finally:
        if out:
            lib.dj_free(out)


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise ImportError(f"the native MIDI decoder is unavailable: {_WHY}")
    return lib


def native_decode_file(path: str, notes_per_beat: int = 4,
                       step: int = 0) -> np.ndarray:
    """Decode a .mid file to a [T, 128, 3] float64 roll.  step=0 derives
    the step from the file's resolution (midi_decode's default).  Raises
    RuntimeError on a parse failure, ImportError without the library."""
    lib = _library()
    out = ctypes.POINTER(ctypes.c_double)()
    frames = ctypes.c_int64()
    rc = lib.dj_decode_file(os.fsencode(path), notes_per_beat, step,
                            ctypes.byref(out), ctypes.byref(frames))
    if rc != 0:
        raise RuntimeError(f"native MIDI decode failed (code {rc}): {path}")
    return _roll(lib, out, frames)


def native_decode_bytes(data: bytes, notes_per_beat: int = 4,
                        step: int = 0) -> np.ndarray:
    """Decode an in-memory .mid buffer (native_decode_file's contract)."""
    lib = _library()
    out = ctypes.POINTER(ctypes.c_double)()
    frames = ctypes.c_int64()
    rc = lib.dj_decode_buffer(data, len(data), notes_per_beat, step,
                              ctypes.byref(out), ctypes.byref(frames))
    if rc != 0:
        raise RuntimeError(f"native MIDI decode failed (code {rc})")
    return _roll(lib, out, frames)
