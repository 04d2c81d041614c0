"""train.optimizer_device_ms: the card's time in the `train.optimizer`
span (Nadam's update of every leaf), ms a step, by the span's CUDA
events, idle inside it included.  Over the traced run's first steps
(`program_spans`); none without a card.  Moves train_timesteps_per_s."""

from portbench import program_spans


def read(run):
    got = program_spans.steps(run)
    if got is None:
        return None
    return got.device_ms(lambda s: s.name == "train.optimizer")
