"""Kernels (csrc/moe.cu, moe_grouped): % of the routed experts' roofline
bound, max(operations / 989 TFLOP/s, bytes / 3.35 TB/s) of one pass's
routed work (benchmark/flops/moe_grouped.py, from the configuration and the
pass's kept tokens), over the device seconds of the operations named
moe_grouped in the profiled slice (one pass). Moves score_rows_per_s."""

from benchmark.flops import moe_grouped, peaks
from benchmark.harness import trace


def read(run):
    seconds = trace.kernel_seconds(run.summary, "moe_grouped")
    if seconds <= 0:
        return None
    ops, nbytes = moe_grouped.count(run.config, *moe_grouped.pass_tokens(run))
    bound = max(ops / peaks.peak("bf16_flops", run.card),
                nbytes / peaks.peak("hbm_bytes_per_s", run.card))
    return 100.0 * bound / seconds
