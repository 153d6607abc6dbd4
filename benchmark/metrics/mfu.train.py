"""Model step (whole): % of the bf16 peak in model operations (3x the forward)
of the samples trained in the untraced window. Moves train_samples_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.mfu(run)
