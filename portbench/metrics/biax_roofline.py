"""biax_roofline: the least time of the biaxial kernels 2-5 (the time and
note stacks' forward and backward, `arith.biax_bound_ms`) a training step,
over the device time the traced steps spent in their kernels, as a share
(%).  Moves train_timesteps_per_s."""

from portbench import arith, kernels

STACKS = ("biax_time_fwd", "biax_time_bwd", "biax_note_fwd",
          "biax_note_bwd")


def read(run):
    got = kernels.device_s(run, kernels.BIAX)
    if got is None or run.model["time_axis_kind"] != "lstm":
        return None
    f, d = run.facts, arith.Dims.from_config(run.model)
    bf16 = f["compute_dtype"] == "bfloat16"
    bound_ms = sum(arith.biax_bound_ms(k, d, f["batch"], f["seq_len"],
                                       bf16)[0] for k in STACKS)
    return 100.0 * bound_ms * f["trace_steps"] / (got[0] * 1e3)
