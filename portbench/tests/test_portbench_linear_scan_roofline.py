"""linear_scan_roofline's least time against the hand count at the linear
cell's shapes, and its reading from a traced window."""

import types

import pytest

from portbench import run as pr
from portbench.tests import helpers

roofline = pr._reader(helpers.ROOT, "linear_scan_roofline")


def test_bound_at_b64():
    # S 128, R 64 x 48, H 256, bfloat16: the forward reads P (2H) and
    # writes hs (H), the backward reads P, hs, dhs and writes dP: 9 S R H
    # elements of 2 bytes, 1,208 + 604 MB, 0.541 ms a layer at 3.35 TB/s.
    S, R, H = 128, 64 * 48, 256
    elements = 9 * S * R * H
    assert elements * 2 == pytest.approx(1.812e9, rel=1e-3)
    biases = 3 * 2 * H * 4                  # b read twice, db written
    want = (2 * elements + biases) / 3.35e12 * 1e3
    assert roofline.bound_ms(S, R, H, 2) == pytest.approx(want)
    two_layers = 2 * roofline.bound_ms(S, R, H, 2)
    assert two_layers == pytest.approx(1.08, abs=0.005)


class _Profile:
    def __init__(self, kernels):
        self.kernels = kernels

    def device_s(self, match):
        hit = [s for name, s in self.kernels if match(name)]
        return sum(hit), len(hit)


def _run(kernels, kind="linear"):
    model = {"time_axis_kind": kind, "num_notes": 48,
             "time_axis_layers": 2, "time_axis_units": 256,
             "compute_dtype": "bfloat16"}
    return types.SimpleNamespace(
        profile=_Profile(kernels), model=model,
        facts={"seq_len": 128, "batch": 64, "trace_steps": 12})


def test_reads_the_glru_kernels_only():
    step = 2 * roofline.bound_ms(128, 3072, 256, 2) / 1e3
    kernels = [("void glru_fwd_kernel<__nv_bfloat16, 4>(...)", 6 * step),
               ("void glru_bwd_kernel<__nv_bfloat16, 4>(...)", 6 * step),
               ("void at::native::reduce_kernel<512, 1>(...)", 9.0),
               ("void biax::scan_cluster_kernel<2>(...)", 9.0)]
    # 12 steps' least time in kernels that took 12 steps' least time.
    assert roofline.read(_run(kernels)) == pytest.approx(100.0)


def test_reads_nothing_without_its_kernels():
    assert roofline.read(_run([("void at::native::x(...)", 1.0)])) is None
    assert roofline.read(_run([("void glru_fwd_kernel<float, 4>()", 1.0)],
                              kind="lstm")) is None
    assert roofline.read(types.SimpleNamespace(profile=None)) is None
