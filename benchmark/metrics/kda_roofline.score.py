"""Kernels (csrc/kda.cu, the KDA core): % of its roofline bound, max(operations
/ 989 TFLOP/s, bytes / 3.35 TB/s) of one pass's KDA work
(benchmark/flops/kda.py, from the configuration and the pass's kept tokens),
over the device seconds of the operations named kda_ in the profiled slice
(one pass). Moves score_rows_per_s."""

from benchmark.flops import kda, moe_grouped, peaks
from benchmark.harness import trace


def read(run):
    seconds = trace.kernel_seconds(run.summary, "kda_")
    if seconds <= 0:
        return None
    ops, nbytes = kda.count(run.config, moe_grouped.pass_tokens(run)[0])
    bound = max(ops / peaks.peak("bf16_flops", run.card),
                nbytes / peaks.peak("hbm_bytes_per_s", run.card))
    return 100.0 * bound / seconds
