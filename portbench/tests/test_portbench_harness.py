"""The harness on the CPU: every cell's traffic, check and per-layer
readers at test widths, the result line's keys, and the contract's
refusals."""

import json
import math
import subprocess
import sys

import pytest

from portbench import run as pr
from portbench.tests import helpers

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _metric_names(section: str, cell: str) -> set:
    return {m["name"] for m in helpers.BENCH[section]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("name", helpers.CELLS)
def test_cell_end_to_end_line(name):
    res = helpers.execute(name)
    assert list(res)[:5] == LINE_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == _metric_names("end_to_end", name)
    for m in res["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert set(res["checks"]) == set(helpers.files(name)["limits"]["limits"])
    json.dumps(res)


@pytest.mark.parametrize("name", helpers.CELLS)
def test_cell_traced_line(name):
    """A traced run on the CPU reports every per-layer metric of the cell
    that needs no device trace, and none that does: there is no card."""
    res = helpers.execute(name, trace=True)
    assert res["correct"] is True, res["checks"]
    want = {m["name"] for m in helpers.BENCH["per_layer"]
            if name in m["workloads"] and m["source"] != "device_trace"}
    assert set(res["metrics"]) == want and want
    assert res["device"]["busy_s"] == 0.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_each_metric_has_a_reader_and_a_reporting_cell():
    e2e = {m["name"]: m for m in helpers.BENCH["end_to_end"]}
    for m in helpers.BENCH["per_layer"]:
        assert (helpers.ROOT / "portbench" / "metrics"
                / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", helpers.CELLS)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         helpers.CELLS[0], "--seed", "1", "--seconds", "1"],
        cwd=helpers.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_outside_a_checkout_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone has no program
    to run."""
    import shutil
    shutil.copy(helpers.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(helpers.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         helpers.CELLS[0], "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_imports_no_jax():
    """A whole CPU run of a cell, in a fresh process, leaves no module of
    jax, jaxlib, flax or the JAX package loaded."""
    code = ("from portbench.tests import helpers; from portbench import run; "
            f"helpers.execute({helpers.CELLS[0]!r}); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=helpers.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "music_generator_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert pr.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert pr.forbidden_modules() == ["jax.numpy"]


def test_large_seed_and_determinism():
    from portbench.drivers.common import sub_seed
    from portbench.drivers.generate import mixtures
    cm = pr.Run.model.fget(type("R", (), {"config": helpers.files(
        "deepj.gen_g128")["config"]})())
    a = mixtures(cm, 2**33 + 5, 3, 128)
    assert (a == mixtures(cm, 2**33 + 5, 3, 128)).all()
    assert not (a == mixtures(cm, 2**33 + 6, 3, 128)).all()
    assert sub_seed(2**40, 1) == sub_seed(2**40, 1) < 2**63
