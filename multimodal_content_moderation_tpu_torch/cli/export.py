#!/usr/bin/env python
"""Export a checkpoint to the reference format (the JAX package's
``cli/export.py``).

Reads a ``checkpoint-N`` of the port's own run directory (``"format":
"torch"``) or a reference-format checkpoint, and writes
``OUTPUT_DIR/checkpoint-exported/model.safetensors`` (the reference's exact
state-dict layout, ``models/export.py``) with the tokenizer and
preprocessor files of the encoder directory, and
``OUTPUT_DIR/inference_config.json`` (``format`` dropped,
``best_checkpoint_dir`` set), so that the reference, the JAX package and
the port load the bundle as it is. An Orbax run directory of the JAX
package stays that package's to export.

    python -m multimodal_content_moderation_tpu_torch.cli.export \\
        --checkpoint RUN/checkpoint-N --output_dir exported/
"""

from __future__ import annotations

import argparse
import os
import shutil

# the encoder files a bundle carries (the JAX export's list)
ASSETS = (
    "vocab.json",
    "merges.txt",
    "vocab.txt",  # BERT-family WordPiece (generic backend)
    "special_tokens_map.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "preprocessor_config.json",
    "config.json",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export a checkpoint to the reference format (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--checkpoint", required=True,
                   help="the port's checkpoint-N, or a reference-format checkpoint")
    p.add_argument("--encoder_dir", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                   help="where the model is loaded; cuda needs a card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.models.export import export_safetensors
    from multimodal_content_moderation_tpu_torch.utils.config import load_json, save_json

    model, cfg = model_io.load_checkpoint(args.checkpoint, args.encoder_dir, device=args.device)
    # the encoder files: the encoder directory's, else the checkpoint's own
    enc = args.encoder_dir or cfg.get("encoder_dir") or args.checkpoint
    enc_json = os.path.join(enc, "config.json")
    encoder_config = load_json(enc_json) if os.path.exists(enc_json) else None

    ckpt_dir = os.path.join(args.output_dir, "checkpoint-exported")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = export_safetensors(model, os.path.join(ckpt_dir, "model.safetensors"),
                              encoder_config)

    out_cfg = dict(cfg)
    out_cfg.pop("format", None)  # the reference format
    out_cfg["best_checkpoint_dir"] = ckpt_dir
    save_json(out_cfg, os.path.join(args.output_dir, "inference_config.json"))

    # the tokenizer and preprocessor files, so that the bundle stands alone
    if os.path.isdir(enc):
        for name in ASSETS:
            src = os.path.join(enc, name)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(ckpt_dir, name))

    print(f"Exported reference-format checkpoint to: {path}")
    return path


if __name__ == "__main__":
    main()
