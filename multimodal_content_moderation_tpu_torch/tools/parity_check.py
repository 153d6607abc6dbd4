"""Feature-parity checker: the port vs the PyTorch/HF reference (the JAX
package's ``tools/parity_check.py``).

For users holding real checkpoint assets (a local clone of the encoder
and/or a reference checkpoint or a port run directory), verifies that the
CLIP text and image features of the port's model (``model_io.load_checkpoint``)
agree with ``transformers.CLIPModel.get_text_features`` /
``get_image_features`` to the 1e-3 target (BASELINE.md). Needs
``transformers``, which this tool imports; it is a CPU-side tool wherever
``transformers`` is installed.

Usage:
    python -m multimodal_content_moderation_tpu_torch.tools.parity_check \\
        --checkpoint runs/exp/checkpoint-N [--encoder_dir /path/to/clip] \\
        [--n 8] [--tol 1e-3] [--device cpu]

Feeds identical seeded inputs (token ids with EOS at the middle, normal
pixels) through both stacks and reports the max |diff| of each feature.
Prints ``PARITY OK`` (exit 0) or ``PARITY FAILED`` (exit 1).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--encoder_dir", default=None)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the port's model runs; cuda (the default) needs a card")
    return ap.parse_args(argv)


def inputs(model, n: int):
    """(ids [n, T] int64 with EOS at T // 2, an all-ones mask, normal
    pixels [n, 3, H, W]): the JAX tool's draws from ``default_rng(0)``."""
    tcfg = model.clip_config.text
    g = np.random.default_rng(0)
    T = tcfg.max_positions
    ids = g.integers(1, tcfg.vocab_size - 2, size=(n, T)).astype(np.int64)
    ids[:, T // 2] = tcfg.eos_token_id
    mask = np.ones((n, T), np.int64)
    img = model.image_size
    px = g.normal(size=(n, 3, img, img)).astype(np.float32)
    return ids, mask, px


def port_features(model, ids, mask, px):
    """The port's CLIP text and image features (fp32 numpy)."""
    from multimodal_content_moderation_tpu_torch.models.clip import (
        clip_image_features,
        clip_text_features,
    )

    dev = model.device
    with torch.no_grad():
        t = clip_text_features(model.backbone, torch.from_numpy(ids).to(dev),
                               torch.from_numpy(mask).to(dev), model.clip_config)
        v = clip_image_features(model.backbone, torch.from_numpy(px).to(dev), model.clip_config)
    return t.float().cpu().numpy(), v.float().cpu().numpy()


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import transformers
    except ImportError:
        raise SystemExit("parity_check: needs the transformers package (the HF reference "
                         "it compares against), which is not installed here") from None

    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.tools._common import hf_features, open_device

    device = open_device(args.device, "parity_check")
    model, cfg = model_io.load_checkpoint(args.checkpoint, args.encoder_dir, device=device)
    enc_dir = args.encoder_dir or cfg.get("encoder_dir") or args.checkpoint

    backend = cfg.get("backend", "clip")
    head = cfg.get("head", "fusion")
    if backend != "clip" or head != "fusion":
        raise SystemExit(
            "parity_check currently drives the clip+fusion flagship; other "
            "combos are covered by the unit suite (tests/test_head_parity.py)"
        )

    hf = transformers.CLIPModel.from_pretrained(enc_dir)
    hf.eval()
    ids, mask, px = inputs(model, args.n)
    with torch.no_grad():
        t_ref = hf_features(hf.get_text_features(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask))).numpy()
        v_ref = hf_features(hf.get_image_features(pixel_values=torch.tensor(px))).numpy()
    t_got, v_got = port_features(model, ids, mask, px)

    t_err = float(np.abs(t_got - t_ref).max())
    v_err = float(np.abs(v_got - v_ref).max())
    print(f"text feature max |diff|:  {t_err:.2e}")
    print(f"image feature max |diff|: {v_err:.2e}")
    ok = t_err < args.tol and v_err < args.tol
    print("PARITY OK" if ok else "PARITY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
