"""The reference's images: PIL's shortest-edge bilinear resize and centre
crop of each committed JPEG fixture at 224 px, computed once with PIL and
kept beside the JPEGs (``assets/jpeg/pil_crops224.npz``), then normalised in
fp32 as torchvision's ``ToTensor`` + ``Normalize`` do. The measured program
decodes the same JPEG bytes with its own decoder."""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                      "jpeg")


def pil_crops() -> Dict[str, np.ndarray]:
    """{fixture name: uint8 [224, 224, 3]}."""
    with np.load(os.path.join(ASSETS, "pil_crops224.npz")) as z:
        return {k: z[k] for k in z.files}


def normalised(crops_u8: np.ndarray, mean: Sequence[float], std: Sequence[float],
               device) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, 3, H, W] fp32 ``(x / 255 - mean) / std``."""
    x = torch.as_tensor(crops_u8, device=device).float() / 255.0
    x = (x - torch.tensor(mean, device=device)) / torch.tensor(std, device=device)
    return x.permute(0, 3, 1, 2).contiguous()
