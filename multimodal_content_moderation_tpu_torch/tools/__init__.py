"""The port's measuring entry points, one configuration per process, each
printing one JSON line (the JAX package's ``bench.py`` and ``tools/bench_*``,
``tools/profile_*``, ``tools/sim_multicore_e2e.py``):

    python bench_torch.py                      # the headline eval bench
    python -m multimodal_content_moderation_tpu_torch.tools.bench_eval --backend siglip

Every such tool runs on the card unless it is given ``--device cpu``, takes
``--tiny`` (narrow two-layer towers and a few small batches: a smoke size,
not a measurement) and ``--seed`` (which makes every input), and adds to its
JAX counterpart's keys ``device`` (the card's name and power limit, or
"cpu"), ``launches`` (each kernel wrapper's launches over the timed window,
and how many ran on the tensor cores) and ``seed``.

Beside them, the JAX package's quality tools: ``quality_parity`` and
``run_fullscale_quality_parity`` (fine-tune an oracle and the port's model on
the same data and compare F1 / ROC; an indented report and an exit code) and
``parity_check`` (the port's CLIP features against ``transformers``).
"""
