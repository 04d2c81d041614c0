"""train.host_issue_ms: the host's time to issue a training step, ms a
step: the `train.step` span's host duration less the wait spans inside it,
over the traced run's first steps (`program_spans`).  Moves
train_timesteps_per_s where the host paces the step."""

from portbench import program_spans


def read(run):
    got = program_spans.steps(run)
    if got is None:
        return None
    step_ns = sum(s.host_ns for s in got.steps)
    wait_ns = sum(s.host_ns for s in got.within(lambda s: s.wait))
    return (step_ns - wait_ns) / got.count / 1e6
