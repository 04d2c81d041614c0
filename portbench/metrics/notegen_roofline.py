"""notegen_roofline: the least time of one pitch-loop launch (kernel 1,
`arith.notegen_bound_ms` at G streams and the note depth) over the mean
device time of a launch in the traced calls, as a share (%).  Moves
gen_timesteps_per_s."""

from portbench import arith, kernels


def read(run):
    got = kernels.device_s(run, kernels.NOTEGEN)
    if got is None:
        return None
    d = arith.Dims.from_config(run.model)
    esize = 2 if run.model["gen_dtype"] == "bfloat16" else 4
    bound_ms, _ = arith.notegen_bound_ms(
        run.facts["streams"], d.num_notes, d.time_axis_units,
        d.note_axis_units, run.model["note_axis_layers"], esize)
    return 100.0 * bound_ms / (got[0] * 1e3 / got[1])
