"""The port's span recorder (utils/spans.py) and the benchmark's readers of
it, on the CPU at test widths:

  * off (the default), `span()` is one shared no-op: no event, no hook, no
    span, also over a linear time axis's forward and backward;
  * on, nesting, parents, threads, wait flags and self time; the torch
    profiler turns recording on, into the process-wide recording;
  * one train_step records its phases with exactly one wait, the stack
    seeds' read, on each route with dropout, and none without;
  * the linear time axis records its scan tree and the tree's backward
    once per layer and step;
  * the generation loop's spans, a chunk's host copy a wait;
  * the device-only window's idle gaps named by span
    (portbench/span_trace.py), and each new per-layer reader, to hand
    counts;
  * a traced CPU run of each training cell reports the readings that need
    no card."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from music_generator_tpu_torch.config import test_config as port_config
from music_generator_tpu_torch.generation.sampler import Sampler
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops.linear_scan import GLRUParams, glru_scan
from music_generator_tpu_torch.parallel.train_step import (create_train_state,
                                                           train_step)
from music_generator_tpu_torch.utils import spans

TRAIN_TREE = {"train.step": None, "train.zero_grad": "train.step",
              "train.forward": "train.step", "train.backward": "train.step",
              "train.optimizer": "train.step",
              "deepj.inputs": "train.forward",
              "deepj.time_axis": "train.forward",
              "deepj.note_axis": "train.forward"}


class _Counted:
    """A stand-in for torch.cuda.Event that counts its instances."""
    made = 0

    def __init__(self, **kw):
        type(self).made += 1

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.0


@pytest.fixture
def counted(monkeypatch):
    """torch.cuda.Event and Tensor.register_hook counted, CUDA 'in use'."""
    hooks = []
    real = torch.Tensor.register_hook

    def register_hook(self, fn):
        hooks.append(fn)
        return real(self, fn)

    _Counted.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _Counted)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.Tensor, "register_hook", register_hook)
    return SimpleNamespace(events=lambda: _Counted.made, hooks=hooks)


def _glru(seed=0):
    g = torch.Generator().manual_seed(seed)
    p = GLRUParams(5, 4)
    with torch.no_grad():
        p.kernel.copy_(torch.randn(5, 8, generator=g))
        p.bias.copy_(torch.randn(8, generator=g))
    return p, torch.randn(7, 3, 5, generator=g, requires_grad=True)


def _batch(cfg, B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    T, N = cfg.seq_len, cfg.num_notes
    notes = (torch.rand(B, T, N, 3, generator=g) < 0.3).float()
    targets = (torch.rand(B, T, N, 3, generator=g) < 0.3).float()
    beats = torch.zeros(B, T, cfg.notes_per_bar)
    beats[:, torch.arange(T), torch.arange(T) % cfg.notes_per_bar] = 1.0
    styles = torch.zeros(B, T, cfg.num_styles)
    styles[..., 0] = 1.0
    return notes, targets, beats, styles


def _parent_names(rec):
    by_id = {s.id: s for s in rec.spans}
    return {s.name: (by_id[s.parent].name if s.parent is not None else None)
            for s in rec.spans}


def test_off_is_one_shared_noop(counted):
    assert not spans.is_on()
    kept = len(spans.profiled().spans)
    a, b = spans.span("x"), spans.span("y", wait=True)
    assert a is b is spans._NOOP
    with a as got:
        assert got is None
    p, xs = _glru()
    glru_scan(p, xs).sum().backward()
    assert counted.events() == 0 and counted.hooks == []
    assert len(spans.profiled().spans) == kept
    # The same work recording: events at both ends, the backward's hooks.
    with spans.recording() as rec:
        glru_scan(p, xs).sum().backward()
    assert counted.events() == 4 and len(counted.hooks) == 3
    assert [s.name for s in rec.spans] == ["linear_scan.tree",
                                           "linear_scan.tree.bwd"]


def test_nesting_parents_threads_and_waits():
    with spans.recording() as rec:
        with spans.span("a"):
            with spans.span("b", wait=True):
                pass
            with spans.span("c"):
                with spans.span("d"):
                    pass

            def other():
                with spans.span("e"):
                    pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    assert not spans.is_on()
    got = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["a", "b", "c", "d", "e"]
    assert _parent_names(rec) == {"a": None, "b": "a", "c": "a", "d": "c",
                                  "e": None}
    assert [s.wait for s in rec.spans] == [False, True, False, False, False]
    me = threading.get_ident()
    assert {got[n].thread for n in "abcd"} == {me} and got["e"].thread != me
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns and s.device_ms is None
    assert [c.name for c in rec.children(got["a"])] == ["b", "c"]


def test_self_time_is_duration_less_child_cover():
    rec = spans.Recording()
    mk = lambda i, parent, a, b: spans.Span(i, f"s{i}", parent, 1, False,
                                            a, b)
    # Parent [100, 200]; children [110, 130] and [120, 150] overlap, one
    # [190, 260] runs past the parent's end; a grandchild adds nothing.
    rec.spans = [mk(0, None, 100, 200), mk(1, 0, 110, 130),
                 mk(2, 0, 120, 150), mk(3, 0, 190, 260), mk(4, 1, 111, 112)]
    assert rec.self_ns(rec.spans[0]) == 100 - (40 + 10)
    assert rec.self_ns(rec.spans[1]) == 20 - 1
    assert rec.self_ns(rec.spans[4]) == 1


def test_the_profiler_turns_recording_on():
    spans.clear_profiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.is_on()
        with spans.span("probe.outer"):
            with spans.span("probe.inner", wait=True):
                torch.ones(4).sum()
    assert not spans.is_on()
    got = spans.profiled().spans
    assert [s.name for s in got] == ["probe.outer", "probe.inner"]
    names = [e.name for e in prof.events()]
    assert "probe.outer" in names and "probe.inner" in names
    # A recording opened under the profiler takes its spans.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.recording() as rec:
            with spans.span("probe.own"):
                pass
    assert [s.name for s in rec.spans] == ["probe.own"]
    assert len(spans.profiled().spans) == 2
    spans.clear_profiled()
    assert spans.profiled().spans == []


ROUTES = {"biax": {}, "axis_fused": {"fused_biax_v3": False},
          "linear": {"time_axis_kind": "linear"}}


@pytest.mark.parametrize("dropout", [True, False], ids=["dropout", "none"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_step_records_its_phases(route, dropout):
    over = dict(ROUTES[route])
    if not dropout:
        over.update(dropout=0.0, input_dropout=0.0)
    cfg = port_config(**over)
    state = create_train_state(build_model(cfg, "cpu"), seed=3)
    batch = _batch(cfg)
    with spans.recording() as rec:
        train_step(state, batch)
    parents = _parent_names(rec)
    for name, parent in TRAIN_TREE.items():
        assert parents[name] == parent, name
    waits = [s for s in rec.spans if s.wait]
    assert [s.name for s in waits] == (["deepj.stack_seeds"] if dropout
                                       else [])
    if waits:
        assert parents["deepj.stack_seeds"] == "train.forward"
    names = [s.name for s in rec.spans]
    assert names.count("train.step") == 1 and "train.all_reduce" not in names
    assert all(s.end_ns for s in rec.spans)


def test_linear_scan_tree_once_per_layer_and_step():
    cfg = port_config(time_axis_kind="linear")
    state = create_train_state(build_model(cfg, "cpu"), seed=4)
    with spans.recording() as rec:
        for k in range(2):
            train_step(state, _batch(cfg, seed=k))
    names = [s.name for s in rec.spans]
    L = cfg.time_axis_layers
    assert names.count("linear_scan.tree") == 2 * L
    assert names.count("linear_scan.tree.bwd") == 2 * L
    parents = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "linear_scan.tree":
            assert parents[s.parent].name == "deepj.time_axis"
        if s.name == "linear_scan.tree.bwd":
            # autograd's CPU backward runs on the calling thread
            up = parents[s.parent]
            assert up.name == "train.backward"
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def test_generation_loop_spans():
    cfg = port_config()
    model = build_model(cfg, "cpu", seed=1)
    style = np.eye(cfg.num_styles, dtype=np.float32)[0]
    with spans.recording() as rec:
        Sampler(model).generate([style, style], num_bars=2, seed=5,
                                chunk_bars=1)
    names = [s.name for s in rec.spans]
    steps = 2 * cfg.notes_per_bar
    for name, count in (("gen.chunk", 2), ("gen.uniforms", 2),
                        ("gen.time_step", steps), ("gen.note_sample", steps),
                        ("gen.host_copy", 2), ("gen.assemble", 2)):
        assert names.count(name) == count, name
    assert [s.name for s in rec.spans if s.wait] == ["gen.host_copy"] * 2
    parents = _parent_names(rec)
    assert parents["gen.time_step"] == parents["gen.uniforms"] == "gen.chunk"


# -- the benchmark's side ---------------------------------------------------

def _span(i, name, a, b, wait=False, device_ms=None, parent=None):
    return spans.Span(i, name, parent, 1, wait, a, b, device_ms)


def test_idle_by_span_to_hand_counts():
    from portbench import span_trace, trace
    # Device operations [0, 10], [12, 20], [20, 25], [40, 50], [50.5, 60]
    # (us); a host event's mirror on the device is not an operation.
    us = 1000
    ev = [("k1", True, 0, 10 * us), ("k2", True, 12 * us, 20 * us),
          ("k3", True, 20 * us, 25 * us), ("k1", True, 40 * us, 50 * us),
          ("k2", True, 50 * us + 500, 60 * us),
          ("train.step", False, 0, 60 * us),
          ("train.step", True, 0, 60 * us)]
    sp = [_span(0, "train.step", 0, 60 * us),
          _span(1, "deepj.stack_seeds", 9 * us, 30 * us, wait=True,
                parent=0),
          _span(2, "train.optimizer", 30 * us, 38 * us, parent=0)]
    # Gaps: [10, 12] (mid 11: the seeds' wait), [25, 40] (mid 32.5: the
    # optimizer); [50, 50.5] is under GAP_MIN_NS.
    got = span_trace.idle_by_span(ev, sp)
    assert got == pytest.approx({"deepj.stack_seeds": 2e-6,
                                 "train.optimizer": 15e-6})
    tr = trace.reduce_events(ev, 60e-6)
    short = 0.5e-6
    assert sum(got.values()) == pytest.approx(tr.window_s - tr.busy_s
                                              - short)
    # Both gaps open inside the wait [9, 30].
    assert span_trace.sync_idle_s(ev, sp) == pytest.approx(17e-6)
    assert span_trace.idle_by_span(ev, []) == pytest.approx(
        {"outside": 17e-6})


def _reader(name):
    from portbench import run as pr
    from portbench.tests import helpers
    return pr._reader(helpers.ROOT, name)


@pytest.fixture
def synthetic_run(monkeypatch):
    """A run of two traced steps (1 s after set-up) and a third, later one
    (the host window), with their spans in the process-wide recording."""
    s = 1_000_000_000
    ms = 1_000_000
    t0 = 5 * s
    rec = spans.Recording()
    rec.spans = [
        _span(0, "train.step", t0, t0 + 60 * ms),
        _span(1, "deepj.stack_seeds", t0 + 5 * ms, t0 + 9 * ms, True, 1.5, 0),
        _span(2, "train.optimizer", t0 + 40 * ms, t0 + 55 * ms, False, 3.0,
              0),
        _span(3, "linear_scan.tree.bwd", t0 + 20 * ms, t0 + 30 * ms, False,
              7.0),
        _span(4, "train.step", t0 + 70 * ms, t0 + 120 * ms),
        _span(5, "deepj.stack_seeds", t0 + 75 * ms, t0 + 77 * ms, True, 0.5,
              4),
        _span(6, "train.optimizer", t0 + 100 * ms, t0 + 110 * ms, False, 5.0,
              4),
        _span(7, "linear_scan.tree", t0 + 80 * ms, t0 + 85 * ms, False, 1.0,
              4),
        _span(8, "train.step", t0 + 200 * ms, t0 + 300 * ms),
        _span(9, "deepj.stack_seeds", t0 + 210 * ms, t0 + 220 * ms, True,
              9.0, 8),
    ]
    monkeypatch.setattr(spans, "profiled", lambda: rec)
    return SimpleNamespace(facts={"trace_steps": 2}, t0=0.0, setup_s=4.0,
                           closed_at=6.0), rec


@pytest.mark.parametrize("name,want", [
    ("train.host_syncs_per_step", 1.0),
    ("train.host_issue_ms", ((60 - 4) + (50 - 2)) / 2),
    ("train.sync_idle_ms", (1.5 + 0.5) / 2),
    ("train.optimizer_device_ms", (3.0 + 5.0) / 2),
    ("linear_scan.device_ms", (7.0 + 1.0) / 2),
])
def test_readers_to_hand_counts(synthetic_run, name, want):
    run, rec = synthetic_run
    assert _reader(name).read(run) == pytest.approx(want)
    # Without device times (no card) only the host readings remain.
    for s in rec.spans:
        s.device_ms = None
    got = _reader(name).read(run)
    assert (got is None) == (name not in ("train.host_syncs_per_step",
                                          "train.host_issue_ms"))


@pytest.mark.parametrize("name", ["train.host_syncs_per_step",
                                  "train.sync_idle_ms",
                                  "linear_scan.device_ms"])
def test_readers_without_the_program_spans(synthetic_run, monkeypatch, name):
    """A checkout without the span module, or a run before the trace, reads
    nothing and raises nothing."""
    import sys
    from music_generator_tpu_torch import utils
    run, _ = synthetic_run
    assert _reader(name).read(run) is not None
    monkeypatch.setitem(sys.modules, "music_generator_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(utils, "spans")
    assert _reader(name).read(run) is None
    run.facts = {}
    assert _reader(name).read(run) is None


@pytest.mark.parametrize("cell", ["deepj.train_b64", "deepj_linear.train_b64"])
def test_traced_cpu_run_reports_the_host_readings(cell):
    """In a process of its own: a run refuses to give a result with JAX
    loaded, as it is in this one."""
    import json
    import subprocess
    import sys
    from portbench.tests import helpers
    code = ("import json; from portbench.tests import helpers; "
            f"print(json.dumps(helpers.execute({cell!r}, trace=True, "
            "seconds=0.2)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=helpers.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    assert m["train.host_syncs_per_step"]["value"] == 1.0
    assert m["train.host_issue_ms"]["value"] > 0
    for name in ("train.sync_idle_ms", "train.optimizer_device_ms",
                 "linear_scan.device_ms"):
        assert name not in m
