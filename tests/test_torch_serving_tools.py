"""The port's serving entry points on the CPU at test_config(): they refuse
to run without a card unless the CPU is asked for, `serve_main` builds and
starts a server, and `tools/bench_serving.py` runs its six workloads."""

import json
import os

import pytest
import torch

from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import save_params_npz
from music_generator_tpu_torch.serving import GenerationService, server
from music_generator_tpu_torch.tools import bench_serving

from torch_serving_common import CFG


@pytest.fixture
def params_npz(tmp_path):
    path = str(tmp_path / "params.npz")
    save_params_npz(build_model(CFG, "cpu", seed=0).state_dict(), path)
    return path


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, tmp_path,
                                                   params_npz):
    """No card and no explicit CPU request: raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(server, "default_config", lambda: CFG)
    monkeypatch.setattr(bench_serving, "default_config", lambda: CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationService(config=CFG, warmup=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.serve_main(["--port", "0", "--params", params_npz])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serving.main(["--params", params_npz,
                            "--out", str(tmp_path / "b.json")])
    assert not os.path.exists(tmp_path / "out")
    assert not os.path.exists(tmp_path / "b.json")


def test_serve_main_serves_on_the_cpu(monkeypatch, capsys, params_npz):
    """--device cpu: the weights load, the buckets warm up and the server
    starts (serve_forever stubbed to return at once, then closed)."""
    monkeypatch.setattr(server, "default_config", lambda: CFG)
    served = []
    monkeypatch.setattr(server.DeepJHTTPServer, "serve_forever",
                        lambda self: served.append(self.server_port))
    server.serve_main(["--device", "cpu", "--port", "0", "--params",
                       params_npz, "--warmup-buckets", "2",
                       "--max-batch", "4"])
    out = capsys.readouterr().out
    assert f"Loaded weights from {params_npz}" in out
    assert "warmup: buckets [1, 2] on cpu" in out
    assert len(served) == 1 and f"127.0.0.1:{served[0]}" in out


def test_bench_serving_runs_its_workloads(monkeypatch, tmp_path,
                                          params_npz):
    monkeypatch.setattr(bench_serving, "default_config", lambda: CFG)
    out = tmp_path / "bench.json"
    reps = 1
    results = bench_serving.main([
        "--reps", str(reps), "--device", "cpu", "--params", params_npz,
        "--bars", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == results
    assert list(results)[0] == "card" and results["card"] == "cpu"
    w = results["workloads"]
    assert set(w) == {"solo", "batch16", "primed", "concurrent16",
                      "mixed_bars", "overload"}
    for name in ("solo", "batch16", "primed", "concurrent16"):
        assert len(w[name]["reps_ms"]) == reps
        assert w[name]["min_ms"] <= w[name]["median_ms"]
    assert w["batch16"]["pieces_per_request"] == 16
    calls = w["concurrent16"]["device_calls_per_rep"]
    assert len(calls) == reps and all(1 <= c <= 16 for c in calls)
    for key in ("quiet_ms", "busy_ms", "busy_unbounded_ms"):
        assert len(w["mixed_bars"][key]) == reps
    assert w["mixed_bars"]["long_bars"] == 8
    overload = w["overload"]
    assert overload["shed_503"] + overload["served_200"] == 12
    assert set(overload["status_codes"]) <= {200, 503}
