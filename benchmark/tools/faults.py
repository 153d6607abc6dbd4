"""Faults planted in the measured program under a run, to show that the
comparison deciding ``correct`` catches them (the harness's fault tests, and
the readings on the card that set a training cell's upper limits):

- ``unchanged``: the optimizer's step returns with the state as it was;
- ``half_batch``: the loss is the mean over the first half of the batch;
- ``alter``: an answer changed where it is produced (a logit of the first
  row of every batch the fast engine runs, scored or served);
- ``schedule``: the learning rate held at its peak once the warmup ends,
  where the schedule decays (the checked updates, inside the warmup, are
  untouched).

A one-card cell has no exchange between chips to leave out."""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "alter", "schedule")


@contextlib.contextmanager
def planted(name: str):
    from multimodal_content_moderation_tpu_torch.models import fast_infer, fusion
    from multimodal_content_moderation_tpu_torch.training import optim

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(optim.AdamW, "step", lambda self: True)
    elif name == "half_batch":
        bce = fusion.bce_with_logits

        def half(logits, labels, **kw):
            h = max(logits.shape[0] // 2, 1)
            return bce(logits[:h], labels[:h], **kw)

        patch(fusion, "bce_with_logits", half)
    elif name == "alter":
        call = fast_infer.FastInferenceEngine.__call__

        def altered(self, *a, **k):
            out = call(self, *a, **k).clone()
            out[0, 0] += 0.5
            return out

        patch(fast_infer.FastInferenceEngine, "__call__", altered)
    elif name == "schedule":
        make = optim.make_schedule

        def held(peak, total_steps, warmup_ratio, schedule="cosine"):
            sched = make(peak, total_steps, warmup_ratio, schedule)
            warmup = max(int(total_steps * warmup_ratio), 0)
            return lambda count: sched(count) if count < warmup else peak

        patch(optim, "make_schedule", held)
    else:
        raise ValueError(f"fault {name!r}: want one of {FAULTS}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
