"""Engine (models/fast_infer.FastInferenceEngine): rows a second over one
pass's batches already on the card, to a synchronise. Moves
score_rows_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.measured(run, "engine_rows_per_s")
