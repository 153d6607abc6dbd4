"""Full-scale quality-parity run (the JAX package's
``tools/run_fullscale_quality_parity.py``).

Builds a flagship-shaped fixture and runs ``tools/quality_parity.py`` in
locked mode (identical init, identical data order, dropout off) for ~100
optimizer steps on both sides:

- ``--backend clip``: a ViT-B/32 CLIP encoder directory at the real
  architecture (12+12 layers, text d=512/8 heads, vision d=768/12 heads,
  image 224) with the synthetic 49,408-entry BPE vocabulary;
- ``--backend siglip``: a SigLIP-B/16-224 directory (12+12 layers, d=768 in
  both towers, 196 patch tokens, a MAP head) with a 32,000-entry WordLevel
  ``tokenizer.json``, mean and std 0.5;

each with the port's seeded random weights in the reference
``model.safetensors`` layout, fusion_dim 512, and MMHS-shaped synthetic
data: 5 classes, multi-label, skewed priors, the label and text columns
JAX's tool draws at the same row counts, each row's image the committed
JPEG fixture indexed by its label count. Nothing here needs
``transformers``, ``safetensors``, PIL or pandas (``--oracle reference``
and ``--reference_bf16`` do need ``transformers``).

Real MMHS150K assets are not used (no dataset mount), so this does NOT
reproduce the published 0.569/0.783 numbers; it proves that the training
stack (and with ``--fast`` the production fast recipe) tracks the oracle
step for step at full model scale, the transferable half of the +-0.005
band claim (BASELINE.md).

    python -m multimodal_content_moderation_tpu_torch.tools.run_fullscale_quality_parity \\
        --fast --oracle fp32          # on the card (the default device)
    ... --head mtl --fast --reference_bf16   # HF oracle and its bf16 run
    ... --tiny --device cpu           # two-layer width-64 towers, a few rows

Writes the report to ``--output`` (default under ``build/quality_parity/``),
prints it, then the band check; exits 0 when the band holds.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from multimodal_content_moderation_tpu_torch.tools import _common as c
from multimodal_content_moderation_tpu_torch.tools import quality_parity

PRIORS = np.array([0.35, 0.18, 0.12, 0.04, 0.30])  # rough MMHS skew
WORDS = ["hate", "love", "people", "you", "stop", "go", "bad", "good"]
TINY_ROWS = {"n_train": 16, "n_val": 8}
TOLERANCE = 0.005


def encoder_config(backend: str, tiny: bool):
    """ViT-B/32 CLIP, SigLIP-B/16-224 with a 32,000-entry vocabulary, or
    their two-layer width-64 forms."""
    from multimodal_content_moderation_tpu_torch.models import siglip

    if backend == "clip" or tiny:
        return c.encoder_config(backend, tiny)
    return siglip.SigLIPConfig(text=siglip.SigLIPTextConfig(vocab_size=32000),
                               vision=siglip.SigLIPVisionConfig())


def build_encoder(directory: str, backend: str, tiny: bool = False, seed: int = 0):
    """The encoder directory (config, tokenizer assets, preprocessor config)
    with the port's seeded weights (drawn on the CPU) in the reference
    layout; returns its config."""
    from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel

    cfg = encoder_config(backend, tiny)
    if backend == "clip":
        c.write_clip_encoder_dir(directory, c.hf_clip_config(cfg))
    else:
        c.write_siglip_encoder_dir(directory, cfg)
    model = FusionModel.create(backend, num_labels=len(c.CLASSES), seed=seed, device="cpu",
                               **c.config_kwargs(backend, cfg))
    c.write_encoder_weights(model, directory)
    return cfg


def build_synthetic_mmhs(directory: str, n_train: int, n_val: int) -> None:
    """``train.csv`` and ``val.csv`` (columns text, image_path, labels) and
    their images under ``directory/images``: JAX's draws in JAX's order
    (its 224x224 noise image drawn and dropped), each row's image the
    committed JPEG fixture indexed by its label count (0-5)."""
    from multimodal_content_moderation_tpu_torch.data.dataset import write_records

    img_dir = os.path.join(directory, "images")
    os.makedirs(img_dir, exist_ok=True)
    fixtures = list(c.fixture_jpegs().values())
    g = np.random.default_rng(0)

    def rows(n, offset):
        out = []
        for i in range(n):
            active = [nm for nm, p in zip(c.CLASSES, PRIORS) if g.random() < p]
            img = f"im{i + offset}.jpg"
            base = 40 + 30 * len(active)
            g.integers(base, base + 120, size=(224, 224, 3))  # JAX's image noise
            with open(os.path.join(img_dir, img), "wb") as f:
                f.write(fixtures[len(active)])
            text = " ".join(g.choice(WORDS, size=6).tolist() + ["hate"] * min(len(active), 3))
            out.append({"text": text, "image_path": img, "labels": ",".join(active)})
        return out

    write_records(os.path.join(directory, "train.csv"), rows(n_train, 0))
    write_records(os.path.join(directory, "val.csv"), rows(n_val, 10_000))


def _tower(t) -> str:
    return f"{t.num_layers}L/{t.num_heads}H/d{t.hidden_size}"


def scale(cfg, backend: str, args) -> dict:
    v = cfg.vision
    patches = (v.image_size // v.patch_size) ** 2
    vision = (f"{_tower(v)} ViT-B/{v.patch_size}" if backend == "clip"
              else f"{_tower(v)} SigLIP-B/{v.patch_size} ({patches} patches, MAP head)")
    return {"text": _tower(cfg.text), "vision": vision, "vocab": cfg.text.vocab_size,
            "image": v.image_size, "fusion_dim": 512, "n_train": args.n_train,
            "n_val": args.n_val, "epochs": args.epochs, "batch_size": args.batch_size,
            "tiny": args.tiny}


def default_output(args) -> str:
    suffix = "" if args.backend == "clip" else f"_{args.backend}"
    suffix += "_mtl" if args.head == "mtl" else ""
    suffix += "_fast" if args.fast else ""
    suffix += "_int8" if args.int8_eval else ""
    suffix += "_tiny" if args.tiny else ""
    return os.path.join("build", "quality_parity", f"quality_parity_fullscale{suffix}.json")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_train", type=int, default=None, help="default 400")
    ap.add_argument("--n_val", type=int, default=None, help="default 96")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--head", choices=["fusion", "mtl"], default="fusion")
    ap.add_argument("--backend", choices=["clip", "siglip"], default="clip")
    quality_parity.add_args(ap)
    ap.add_argument("--tiny", action="store_true",
                    help="two-layer width-64 towers and 16 / 8 rows: a smoke size for the "
                    "CPU tests")
    ap.add_argument("--output", default="")
    args = ap.parse_args(argv)
    if args.reference_bf16 and args.oracle != "reference":
        ap.error("--reference_bf16 trains the reference model: it needs --oracle reference")
    for key, full in (("n_train", 400), ("n_val", 96)):
        if getattr(args, key) is None:
            setattr(args, key, TINY_ROWS[key] if args.tiny else full)
    args.output = args.output or default_output(args)
    return args


def run_settings(backend: str, head: str) -> dict:
    """The run's settings besides the fixture: locked mode, lr 1e-4, weight
    decay 0.01, fusion_dim 512, text width 77 (CLIP) or 64 (SigLIP), the
    multi-task head's hidden width 256."""
    return {"mode": "locked", "lr": 1e-4, "weight_decay": 0.01, "fusion_dim": 512,
            "max_text_length": 64 if backend == "siglip" else 77, "head": head,
            "head_hidden_dim": 256 if head == "mtl" else 0, "backend": backend}


def main(argv=None) -> int:
    args = parse_args(argv)
    c.open_device(args.device, "fullscale-parity")  # no card: exit before any work
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        enc = os.path.join(tmp, "encoder")
        data = os.path.join(tmp, "data")
        print(f"[fullscale-parity] building the {args.backend} fixture ...", flush=True)
        cfg = build_encoder(enc, args.backend, args.tiny)
        build_synthetic_mmhs(data, args.n_train, args.n_val)
        print("[fullscale-parity] training both sides (locked mode) ...", flush=True)
        report = quality_parity.run(
            enc,
            os.path.join(data, "train.csv"),
            os.path.join(data, "val.csv"),
            image_root=os.path.join(data, "images"),
            epochs=args.epochs,
            batch_size=args.batch_size,
            **run_settings(args.backend, args.head),
            fast=args.fast,
            int8_eval=args.int8_eval,
            oracle=args.oracle,
            device=args.device,
            reference_bf16=args.reference_bf16,
        )
    report["scale"] = scale(cfg, args.backend, args)
    report["wallclock_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    ok = quality_parity.within_band(report, TOLERANCE)
    print(f"[fullscale-parity] band check (+-{TOLERANCE}): {'PASS' if ok else 'FAIL'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
