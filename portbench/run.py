"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration is `portbench/configs/<config>.json`,
its traffic `portbench/traffic/<traffic>.json`, whose `driver` names the
general generator under `portbench/drivers/` that runs it, and each
per-layer metric is read by `portbench/metrics/<metric>.py`.  Nothing of
the harness names a cell, a configuration or a metric.

A run sets up (builds or loads the kernels, makes the inputs and weights
from the seed, warms up the cell's shapes), measures for `--seconds`,
checks what the timed path produced against the plain reference of
`portbench/reference/`, and prints one JSON line last on standard output:
the cell's end-to-end metrics with `--trace 0`, its per-layer metrics
with `--trace 1` (which adds a profiled window after the measured one).
Each number compared with the reference is printed beside its limit, as
the last lines on standard error and under `checks`, the line's last key.

It exits non-zero, printing no result, when the card or the number of
cards the cell asks for is missing, or when `jax`, `jaxlib`, `flax` or the
JAX package is loaded once the window has closed."""

from __future__ import annotations

import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "music_generator_tpu")
PROGRAM = "music_generator_tpu_torch"


class RunError(Exception):
    """A run that cannot give a result; the message goes to stderr."""


def _process_start() -> float:
    """The process's start time (epoch seconds) from /proc, else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return PROCESS_T0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    as whole names (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver reads and fills: the cell's files, the arguments, and
    its results."""
    root: Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: "object"
    t0: float
    setup_s: Optional[float] = None
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    facts: Dict[str, object] = dataclasses.field(default_factory=dict)
    checks: List[Check] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    profile: Optional[object] = None
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    closed_at: Optional[float] = None

    @property
    def model(self) -> dict:
        """The configuration's sizes as run: its Config values and the
        values derived from them."""
        return {**self.config["config"], **self.config["derived"]}

    def log(self, *args) -> None:
        print(*args, file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup(self) -> None:
        """The end of set-up: every shape of the cell warmed up."""
        self.sync()
        self.setup_s = time.time() - self.t0
        if self.device.type == "cuda":
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_closed(self) -> None:
        """Read the memory peak and look for JAX, before the reference
        runs."""
        import torch
        self.sync()
        self.closed_at = time.time()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        bad = forbidden_modules()
        if bad:
            raise RunError(f"modules of JAX or the JAX package are loaded: "
                           f"{', '.join(bad)}")

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append(Check(name, float(value), float(limit)))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def _check_program(root: Path) -> None:
    """The program must be the checkout's own."""
    mod = importlib.import_module(PROGRAM)
    where = Path(mod.__file__).resolve().parent.parent
    if where != root.resolve():
        raise RunError(f"{PROGRAM} was imported from {where}, not from the "
                       f"checkout {root}")


def _reader(root: Path, name: str):
    """The reader of per-layer metric `name`: portbench/metrics/<name>.py,
    loaded by its path (a name may hold dots)."""
    import importlib.util
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(bench: dict, run: Run, section: str) -> dict:
    """The cell's metrics of one section of BENCHMARK.json, each read by
    the driver (end to end) or by its reader (per layer); a reader that
    finds nothing leaves its metric out."""
    out = {}
    for m in bench[section]:
        if "workloads" in m and run.cell["name"] not in m["workloads"]:
            continue
        if section == "end_to_end":
            value = (run.setup_s if m["name"] == "setup_s"
                     else run.e2e.get(m["name"]))
        else:
            value = _reader(run.root, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device=None, bench: Optional[dict] = None,
            config: Optional[dict] = None, traffic: Optional[dict] = None,
            limits: Optional[dict] = None) -> dict:
    """Run one cell and return its result line.  `device` None means the
    card(s) the cell asks for, which must be there; the CPU tests pass a
    CPU device, and may pass the contents of BENCHMARK.json and of the
    cell's configuration, traffic and limits files in place of the
    files."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cell = _cell(bench, workload)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{workload} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} are visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    _check_program(root)
    pb = root / "portbench"
    config = config or load_json(pb / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(pb / "traffic" / f"{cell['traffic']}.json")
    limits = limits or load_json(pb / "limits" / f"{cell['name']}.json")
    run = Run(root, cell, config, traffic, int(seed), float(seconds),
              bool(trace), device, _process_start(),
              limits=limits["limits"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    driver.run(run)
    if run.setup_s is None or run.closed_at is None:
        raise RunError("the driver did not mark set-up's end and the "
                       "window's close")
    run.log(f"set-up {run.setup_s:.1f} s; the check against the reference "
            f"{time.time() - run.closed_at:.1f} s")
    metrics = _metrics(bench, run, "per_layer" if trace else "end_to_end")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": all(c.ok for c in run.checks) and bool(run.checks),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
        result["breakdown"] = run.profile.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in run.checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    # Any kernel cache of the process lives at a fixed path in the
    # checkout (the port's own nvcc builds go to build/torch_kernels/).
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(root / "build" / "portbench" / "triton"))
    try:
        result = execute(root, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
