"""Kernels (csrc/attention_nhd_bwd.cu): % of the backward's roofline bound in
the profiled slice. Moves train_samples_per_s."""

from benchmark.harness import readers


def read(run):
    return readers.roofline(run, "attention_nhd_bwd")
