"""lstm2_roofline: the least time of the fused two-layer stack's forward
and backward (kernels 6-7, `arith.lstm_bound_ms`) at the note axis's
shapes (S = the notes, R = B T rows, F = time units + note units, H = note
units) a training step, over the device time the traced steps spent in
their kernels, as a share (%).  Moves train_timesteps_per_s."""

from portbench import arith, kernels


def read(run):
    got = kernels.device_s(run, kernels.LSTM2)
    if got is None or run.model["time_axis_kind"] != "linear":
        return None
    f, d = run.facts, arith.Dims.from_config(run.model)
    S, R = d.num_notes, f["batch"] * f["seq_len"]
    F, H = d.time_axis_units + d.note_units, d.note_axis_units
    bound_ms = sum(arith.lstm_bound_ms(k, S, R, F, H)[0]
                   for k in ("lstm2_fwd", "lstm2_bwd"))
    return 100.0 * bound_ms * f["trace_steps"] / (got[0] * 1e3)
