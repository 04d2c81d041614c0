"""What the port's data-parallel tests share: ranks of
music_generator_tpu_torch/tools/mp_worker.py started on the CPU over gloo
on 127.0.0.1, and a free port for them."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(out: str, modes: str, *flags, world: int = 2, timeout=240):
    """Run `world` ranks of tools/mp_worker.py (one thread each) and
    return each rank's (json, npz); a rank that fails fails the caller
    with its output."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = []
    for r in range(world):
        with open(f"{out}.{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "music_generator_tpu_torch.tools.mp_worker", str(r),
                 str(world), str(port), out, modes, "--device", "cpu",
                 "--threads", "1",
                 *map(str, flags)], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} failed:\n{open(f'{out}.{r}.log').read()[-4000:]}"
    return [(json.load(open(f"{out}.{r}.json")), np.load(f"{out}.{r}.npz"))
            for r in range(world)]
