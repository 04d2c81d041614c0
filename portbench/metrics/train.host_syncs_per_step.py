"""train.host_syncs_per_step: the program's wait spans (the host blocking
on the card, such as `deepj.stack_seeds`) inside its `train.step` spans,
a step, over the traced run's first steps (`program_spans`).  Moves
train_timesteps_per_s: each wait drains the card's queue."""

from portbench import program_spans


def read(run):
    got = program_spans.steps(run)
    if got is None:
        return None
    return len(got.within(lambda s: s.wait)) / got.count
