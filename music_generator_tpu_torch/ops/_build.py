"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/torch_kernels/lib<name>-<hash>.so

into `build/torch_kernels/` at the root of the checkout (git-ignored).
The file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source rebuilds and a stale
library is never loaded.  No `--use_fast_math`:
the kernels' float32 math must track the plain PyTorch versions.  The
compiler's register and shared-memory report (`-Xptxas=-v`) is kept beside
the library as `<lib>.log`.

A build holds an exclusive `fcntl` lock on `build/torch_kernels/lock`, so
the ranks of a data-parallel run on one machine compile once: the first
compiles, the others wait and then find the libraries built.  The kernel
releases the lock when its holder exits, however it exits.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda's, else
    the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named kernel whose library is missing, all nvcc
    processes started together; returns the library paths.  Raises with
    the compiler's output when a build fails."""
    names = list(names)
    with build_lock(BUILD_DIR):
        _build_locked(names)
    return [library_path(n) for n in names]


@contextlib.contextmanager
def build_lock(directory: Path):
    """Hold an exclusive `fcntl` lock on `directory`/lock (created with the
    directory), so that the processes of one machine build one at a time;
    the kernel releases it when its holder exits, however it exits."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _build_locked(names: List[str]) -> None:
    procs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        Path(str(lib) + ".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use and loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def bind(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """load(name) with the argument types of each named C function set;
    every one returns an int, the CUDA error code (0 = ok)."""
    lib = load(name)
    for fn, args in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = list(args)
            f.restype = ctypes.c_int
    return lib
