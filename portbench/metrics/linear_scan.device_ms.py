"""linear_scan.device_ms: the card's time in the linear time axis's
associative scan tree, forward (`linear_scan.tree`) and backward
(`linear_scan.tree.bwd`), every layer's, ms a step, by the spans' CUDA
events, idle inside them included.  Over the traced run's first steps
(`program_spans`); none without a card or a linear time axis.  Moves
train_timesteps_per_s."""

from portbench import program_spans

NAMES = ("linear_scan.tree", "linear_scan.tree.bwd")


def read(run):
    got = program_spans.steps(run)
    if got is None:
        return None
    return got.device_ms(lambda s: s.name in NAMES)
