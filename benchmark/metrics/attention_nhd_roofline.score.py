"""Kernels (csrc/attention_nhd.cu): % of the forward's roofline bound in the
profiled slice. Moves score_rows_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.roofline(run, "attention_nhd")
