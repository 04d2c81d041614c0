"""train_mfu: model FLOPs of the measured window's training steps over
the window's time, as a share (%) of the card's peak for the compute
dtype (bfloat16: 989 TFLOP/s).  Moves train_timesteps_per_s."""

from portbench import arith


def read(run):
    f = run.facts
    if "steps" not in f or "batch" not in f:
        return None
    flops = arith.train_step_flops(arith.Dims.from_config(run.model),
                                   f["batch"], f["seq_len"]) * f["steps"]
    peak = (arith.BF16_FLOP_PER_S if f["compute_dtype"] == "bfloat16"
            else arith.F32_FLOP_PER_S)
    return 100.0 * flops / f["window_s"] / peak
