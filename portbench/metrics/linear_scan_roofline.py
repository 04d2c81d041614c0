"""linear_scan_roofline: the least time of the linear time axis's fused
recurrence (`csrc/glru_scan.cu`, its forward and backward kernels) a
training step, over the device time the traced steps spent in those
kernels, as a share (%).  The least time counts each tensor the kernels
read or write once at HBM rate: forward P [S, R, 2H] and the bias [2H]
read, hs [S, R, H] written; backward P, hs, dhs and the bias read, dP and
the bias gradient written; S the timesteps, R = B N rows, H the time
units, in the compute dtype (the bias and its gradient float32), for every
time-axis layer.  None where the trace shows none of the kernels (another
time axis, or a program without them).  Moves train_timesteps_per_s."""

from portbench import arith, kernels

NAMES = ("glru_fwd_kernel", "glru_bwd_kernel")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_ms(S: int, R: int, H: int, itemsize: int) -> float:
    """Least ms of one layer's forward and backward at these shapes."""
    seq, bias = S * R * H * itemsize, 2 * H * 4
    fwd = 2 * seq + bias + seq                  # P, bias; hs
    bwd = 2 * seq + seq + seq + bias + 2 * seq + bias   # P, hs, dhs, b; dP, db
    return (fwd + bwd) / arith.HBM_BYTES_PER_S * 1e3


def read(run):
    got = kernels.device_s(run, NAMES)
    if got is None or run.model["time_axis_kind"] != "linear":
        return None
    f, m = run.facts, run.model
    S, R = f["seq_len"], f["batch"] * m["num_notes"]
    per_step = m["time_axis_layers"] * bound_ms(
        S, R, m["time_axis_units"], ITEMSIZE[m["compute_dtype"]])
    return 100.0 * per_step * f["trace_steps"] / (got[0] * 1e3)
