"""Model step (whole): % of the bf16 peak in model operations of the rows
scored in the untraced window. Moves score_rows_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.mfu(run)
