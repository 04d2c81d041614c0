"""gen_mfu: model FLOPs of the measured window's generated
stream-timesteps over the window's time, as a share (%) of the card's
float32 peak (67 TFLOP/s; generation runs float32 with TF32 off).  Moves
gen_timesteps_per_s."""

from portbench import arith


def read(run):
    f = run.facts
    if "calls" not in f:
        return None
    if run.model["gen_dtype"] != "float32":
        return None
    flops = (arith.gen_timestep_flops(arith.Dims.from_config(run.model))
             * f["calls"] * f["streams"] * f["steps"])
    return 100.0 * flops / f["window_s"] / arith.F32_FLOP_PER_S
