"""The yardstick's arithmetic against hand counts at DeepJ's published
widths (`default_config()`: time 2x256, note 2x128, conv 64, 48
pitches), and the trace reduction against a hand-made timeline."""

import pytest

from portbench import arith, kernels, trace
from portbench import run as pr
from portbench.tests import helpers


def dims(name="deepj"):
    c = pr.load_json(helpers.ROOT / "portbench" / "configs" / f"{name}.json")
    return arith.Dims.from_config({**c["config"], **c["derived"]})


def test_feature_dim():
    assert dims().feature_dim == 1 + 12 + 1 + 64 + 16 == 94


def test_generation_flops_per_stream_timestep():
    # conv: 48 pitches x (24 x 3) x 64 multiply-adds
    conv = 2 * 48 * 72 * 64
    time_axis = 2 * 48 * ((94 + 256) * 1024 + (256 + 256) * 1024)
    note_axis = 2 * 48 * ((259 + 128) * 512 + (128 + 128) * 512 + 128 * 3)
    assert arith.gen_timestep_flops(dims()) == conv + time_axis + note_axis
    assert arith.gen_timestep_flops(dims()) == pytest.approx(116.8e6,
                                                             rel=1e-3)


def test_train_step_flops_lstm_and_linear():
    R = 64 * 128 * 48
    conv = 2 * R * 72 * 64
    note = 2 * R * (387 * 512 + 256 * 512 + 128 * 3)
    lstm = 2 * R * (350 * 1024 + 512 * 1024)
    glru = 2 * R * (94 + 256) * 512
    assert arith.train_step_flops(dims(), 64, 128) == 3 * (conv + lstm
                                                           + note)
    assert arith.train_step_flops(dims("deepj_linear"), 64, 128) == \
        3 * (conv + glru + note)


def test_bounds_at_b64():
    # time forward: 2 R (F + 3H) 4H + 20 R 4H at 989 TFLOP/s
    R = 128 * 48 * 64
    ops = 2 * R * (94 + 768) * 1024 + 20 * R * 1024
    ms, by = arith.biax_bound_ms("biax_time_fwd", dims(), 64, 128, True)
    assert by == "operations" and ms == pytest.approx(ops / 989e12 * 1e3)
    ms, by = arith.lstm_bound_ms("lstm2_fwd", 48, 8192, 259, 128)
    ops = 2 * 48 * 8192 * (259 + 384) * 512 + 20 * 48 * 8192 * 512
    assert by == "operations" and ms == pytest.approx(ops / 989e12 * 1e3)
    ms, by = arith.notegen_bound_ms(128, 48, 256, 128)
    ops = 2 * 128 * 48 * (256 * 512 + 3 * 512 + 3 * 128 * 512 + 3 * 128)
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)


def test_trace_reduction():
    us = 1000
    ev = [("portbench.train_step", False, 0, 100 * us),
          ("aten::mm", False, 10 * us, 12 * us),
          ("cudaStreamSynchronize", False, 40 * us, 60 * us),
          ("void gemm_mma_kernel<64>(float*)", True, 5 * us, 20 * us),
          ("void scan_cluster_kernel<1>(int)", True, 15 * us, 40 * us),
          ("Memcpy HtoD", True, 70 * us, 80 * us),
          ("void note_heads_kernel(float*)", True, 90 * us, 95 * us),
          ("portbench.train_step", True, 0, 100 * us)]    # its mirror
    t = trace.reduce_events(ev, 100e-6)
    assert t.busy_s == pytest.approx(50e-6)
    # 40-70 us: the sync is open at its middle; 80-90 us: only the step.
    assert t.idle_gaps == {"cudaStreamSynchronize": pytest.approx(30e-6),
                           "portbench.train_step": pytest.approx(10e-6)}
    s, n = t.device_s(kernels.matcher(kernels.BIAX))
    assert (s, n) == (pytest.approx(45e-6), 3)
    assert t.breakdown()["device_ops"][0][0].startswith("void scan")
    assert not kernels.matcher(kernels.NOTEGEN)("void gemm_mma_kernel<1>()")
