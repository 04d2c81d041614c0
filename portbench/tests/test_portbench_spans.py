"""The program's spans against the device trace, on the card
(`python3 -m pytest portbench/tests/test_portbench_spans.py -m card`):
a span and the device's activity share one clock, and a device-only
window shows none of the spans as a device operation."""

import pytest
import torch

from portbench import trace

EDGE_NS = 50_000          # the span's ends against the kernel's, either way


def _device_window(fn, device):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return trace._kineto_events(prof)


@pytest.mark.card
def test_a_span_encloses_its_kernel_on_one_clock(card):
    from music_generator_tpu_torch.utils import spans

    def probe():
        with spans.span("probe.sleep"):
            torch.cuda._sleep(2_000_000)          # ~1 ms at 1.98 GHz
            torch.cuda.synchronize(card)

    # Three in one window; the last is read, past the window's start-up.
    with spans.recording() as rec:
        events = _device_window(lambda: [probe() for _ in range(3)], card)
    s = rec.spans[-1]
    dev = sorted((e for e in events if e[1]), key=lambda e: e[2])
    assert len(dev) == 3, [e[0] for e in dev]     # the sleep kernels alone
    _, _, k0, k1 = dev[-1]
    assert -EDGE_NS <= k0 - s.start_ns <= EDGE_NS, (k0 - s.start_ns)
    assert -EDGE_NS <= s.end_ns - k1 <= EDGE_NS, (s.end_ns - k1)
    # The events' interval holds the kernel and the idle around it, up to
    # the host's return from the synchronise.
    assert k1 - k0 <= s.device_ms * 1e6 <= s.host_ns + 2 * EDGE_NS


@pytest.mark.card
def test_no_span_is_a_device_operation(card):
    """Two training steps at test widths (a linear time axis, so its
    backward span too), profiled with the device's activity alone."""
    from music_generator_tpu_torch.config import test_config
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.parallel.train_step import (
        create_train_state, train_step)
    from music_generator_tpu_torch.utils import spans

    cfg = test_config(time_axis_kind="linear", fused_axis_kernel=False,
                      fused_biax_v3=False)
    state = create_train_state(build_model(cfg, card), seed=1)
    B, T, N = 4, cfg.seq_len, cfg.num_notes
    g = torch.Generator(device=card).manual_seed(2)
    batch = ((torch.rand(B, T, N, 3, generator=g, device=card) < .3).float(),
             (torch.rand(B, T, N, 3, generator=g, device=card) < .3).float(),
             torch.zeros(B, T, cfg.notes_per_bar, device=card),
             torch.zeros(B, T, cfg.num_styles, device=card))
    train_step(state, batch)
    with spans.recording() as rec:
        events = _device_window(
            lambda: [train_step(state, batch) for _ in range(2)], card)
    names = {s.name for s in rec.spans}
    assert {"train.step", "linear_scan.tree.bwd"} <= names
    tr = trace.reduce_events(events, 1.0)
    assert tr.busy_s > 0
    assert not names & set(tr.kernels), names & set(tr.kernels)
