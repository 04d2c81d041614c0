"""Small copies of the cells' files for CPU runs: test widths for the
training cells (the program's plain paths at float32), a few short
streams at the committed checkpoint's widths for generation."""

from pathlib import Path

import torch

from portbench import run as pr

ROOT = Path(__file__).resolve().parents[2]
BENCH = pr.load_json(ROOT / "BENCHMARK.json")
# The generation and served cells are kept for later (PERF.md, open
# questions): their rates and tails spread too widely between runs to hold
# a bound.  Their files stay tested.
_GEN, _SERVE = "deepj.gen_g128", "deepj.serve_mixed"
KEPT = {"workloads": [{"name": _GEN, "config": "deepj",
                       "traffic": "gen_g128", "chips": 1},
                      {"name": _SERVE, "config": "deepj",
                       "traffic": "serve_mixed", "chips": 1}],
        "end_to_end": [{"name": "gen_timesteps_per_s", "unit": "timesteps/s",
                        "workloads": [_GEN]},
                       {"name": "request_ms_p95", "unit": "ms",
                        "workloads": [_SERVE]}],
        "per_layer": [{"name": n, "unit": u, "source": s, "moves": mv,
                       "workloads": [w]}
                      for n, u, s, mv, w in (
                          ("gen_mfu", "%", "host_clock",
                           "gen_timesteps_per_s", _GEN),
                          ("notegen_roofline", "%", "device_trace",
                           "gen_timesteps_per_s", _GEN),
                          ("idle_share.gen", "%", "device_trace",
                           "gen_timesteps_per_s", _GEN),
                          ("serve.pieces_per_device_call", "pieces/call",
                           "program_counter", "request_ms_p95", _SERVE),
                          ("idle_share.serve", "%", "device_trace",
                           "request_ms_p95", _SERVE))]}
BENCHMARK_CELLS = [w["name"] for w in BENCH["workloads"]]
BENCH = {k: v + KEPT.get(k, []) if isinstance(v, list) else v
         for k, v in BENCH.items()}
CELLS = [w["name"] for w in BENCH["workloads"]]


def cell(name: str) -> dict:
    return next(w for w in BENCH["workloads"] if w["name"] == name)


def files(name: str) -> dict:
    """config, traffic and limits of cell `name`, cut to a CPU run."""
    w = cell(name)
    pb = ROOT / "portbench"
    config = pr.load_json(pb / "configs" / f"{w['config']}.json")
    traffic = pr.load_json(pb / "traffic" / f"{w['traffic']}.json")
    limits = pr.load_json(pb / "limits" / f"{name}.json")
    if traffic["driver"] == "train":
        config["config"].update(octave_units=8, style_units=8,
                                time_axis_units=16, note_axis_units=8,
                                bars_per_seq=1, compute_dtype="float32")
        config["derived"]["seq_len"] = 16
        traffic.update(batch=4, corpus_gib=1e-4, trace_steps=2,
                       trace_host_steps=1)
    elif traffic["driver"] == "generate":
        traffic.update(streams=3, bars=1, warmup_bars=1, check_streams=3,
                       keep_per_call=3)
    else:
        traffic.update(rate_per_s=6.0, bars={"1": 0.5, "2": 0.5},
                       warmup_buckets=2, max_batch=4, check_pieces=3,
                       trace_s=0.3)
    return {"config": config, "traffic": traffic, "limits": limits}


def execute(name: str, seed: int = 2**31 + 7, trace: bool = False,
            seconds: float = 0.5) -> dict:
    torch.set_num_threads(2)
    return pr.execute(ROOT, name, seed, seconds, trace,
                      device=torch.device("cpu"), bench=BENCH, **files(name))
