"""train.sync_idle_ms: the card's time inside the program's wait spans,
ms a step, by the spans' CUDA events: from the stream's reaching the wait
(all earlier work done) to its reaching the wait's end, which it does as
soon as the host returns.  The card spends it draining for the read and
idle.  Over the traced run's first steps (`program_spans`); none without
a card.  Moves train_timesteps_per_s."""

from portbench import program_spans


def read(run):
    got = program_spans.steps(run)
    if got is None:
        return None
    return got.device_ms(lambda s: s.wait)
