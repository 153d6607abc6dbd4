"""The reference's answers for rows the program answered: the plain fp32
model (``benchmark/reference``) over the same texts and JPEG fixtures, from
the same seed's weights, which it draws again itself, tokenised by its own
tokenizer and decoded by PIL. Computed in blocks of rows, once the window
has closed and the program's state is freed."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.reference import models as ref
from benchmark.reference import pixels, tokenizers

BLOCK = 256


class Reference:
    def __init__(self, cfg: Dict, seed: int, enc_dir: str, device, lowp: Optional[str] = None,
                 weight_dtype=torch.float32):
        ref.fp32_only()
        self.cfg = cfg
        self.device = device
        self.lowp = lowp
        # the weights the program was given, drawn again (in the dtype the
        # program got them), held in fp32
        self.P = ref.as_fp32(weights.draw(cfg, seed, device, weight_dtype))
        self.tok = tokenizers.load(cfg["tokenizer"], enc_dir)
        self.crops = pixels.pil_crops()

    def encode(self, texts: Sequence[str]):
        return tokenizers.encode_batch(self.tok, texts, self.cfg["max_text_length"])

    def batch(self, texts: Sequence[str], images: Sequence[str]) -> Dict[str, torch.Tensor]:
        ids, mask = self.encode(texts)
        dev = self.device
        crops = np.stack([self.crops[i] for i in images])
        img = self.cfg["image"]
        return {
            "ids": torch.as_tensor(ids, device=dev),
            "mask": torch.as_tensor(mask, device=dev),
            "pixels": pixels.normalised(crops, img["mean"], img["std"], dev),
            "text_present": torch.as_tensor(
                [1.0 if t.strip() else 0.0 for t in texts], device=dev),
            "image_present": torch.ones(len(texts), device=dev),
        }

    @torch.no_grad()
    def logits(self, texts: Sequence[str], images: Sequence[str]) -> np.ndarray:
        out: List[np.ndarray] = []
        for s in range(0, len(texts), BLOCK):
            b = self.batch(texts[s:s + BLOCK], images[s:s + BLOCK])
            out.append(ref.logits(self.cfg, self.P, b, self.lowp).float().cpu().numpy())
        return np.concatenate(out)

    def text_tokens(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)[1].sum(axis=1)


def sample_rows(seed: int, n: int, k: int, lengths: np.ndarray, longest: int = 32) -> np.ndarray:
    """``k`` row indices drawn from the seed, the ``longest`` longest texts
    among them, sorted."""
    g = np.random.default_rng([seed, 5])
    pick = set(g.choice(n, size=min(k, n), replace=False).tolist())
    pick.update(np.argsort(-lengths, kind="stable")[:longest].tolist())
    return np.asarray(sorted(pick))


def free_device() -> None:
    """Hand the device memory of the program's dropped state back."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
