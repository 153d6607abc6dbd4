"""What the port's measuring entry points share: the command-line flags every
tool takes, the card line, the seeded synthetic inputs (token ids, uint8
crops, the byte-level BPE assets, the CSV of committed JPEG fixtures), a
CLIP ViT-B/32 encoder directory and a reference-format checkpoint writer,
the kernels' launch counters, device timing, and the profiler's device time
grouped by kernel family."""

from __future__ import annotations

import argparse
import base64
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.utils.device import resolve_device

CLASSES = ["racist", "sexist", "homophobe", "religion", "otherhate"]
KERNELS = ["patch_embed_u8", "attention_nhd", "attention_nhd_bwd", "flash_attention",
           "attention_small"]


# ---------------------------------------------------------------------------
# flags, device, output
# ---------------------------------------------------------------------------


def add_common_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs; cuda (the default) needs a card")
    ap.add_argument("--tiny", action="store_true",
                    help="narrow two-layer towers and a few small batches: a smoke "
                    "size for the CPU tests, not a measurement")
    ap.add_argument("--seed", type=int, default=0, help="makes the weights and every input")
    return ap


def open_device(name: str, tool: str) -> torch.device:
    """``resolve_device(name)``; without a card (and no ``--device cpu``)
    the tool exits non-zero with the reason and prints no metric line."""
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"{tool}: {e}") from None


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "cpu"."""
    if device.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def emit(result: dict) -> dict:
    """Print the tool's one JSON line; returns ``result``."""
    print(json.dumps(result), flush=True)
    return result


def spread(values) -> Dict[str, float]:
    """Median, min and max of a list of numbers."""
    return {"median": float(np.median(values)), "min": float(min(values)),
            "max": float(max(values))}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def mean_ms(fn: Callable[[int], object], n: int, device: torch.device) -> float:
    """Mean ms of ``fn(i)`` over ``n`` calls after one warm call: CUDA events
    around the calls on the card (the device's time, calls queued back to
    back), the host clock on the CPU."""
    fn(0)
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / n


def staged_rates(run_batch: Callable[[int], object], n_batches: int, batch: int,
                 passes: int, device: torch.device) -> List[float]:
    """Samples/s of ``passes`` passes of ``run_batch(i)`` for i in
    range(n_batches), over inputs already on the device: the host clock
    around each pass, which ends in a synchronise. Warm up before."""
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for i in range(n_batches):
            run_batch(i)
        sync(device)
        rates.append(n_batches * batch / (time.perf_counter() - t0))
    return rates


# ---------------------------------------------------------------------------
# the kernels' launch counters
# ---------------------------------------------------------------------------


def _wrappers():
    from multimodal_content_moderation_tpu_torch.ops.cuda_attention import (
        attention_nhd,
        attention_nhd_bwd,
    )
    from multimodal_content_moderation_tpu_torch.ops.cuda_flash import (
        attention_small,
        flash_attention,
    )
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import patch_embed_u8

    return {"patch_embed_u8": patch_embed_u8, "attention_nhd": attention_nhd,
            "attention_nhd_bwd": attention_nhd_bwd, "flash_attention": flash_attention,
            "attention_small": attention_small}


def launch_counter() -> Callable[[], Dict[str, int]]:
    """Set every kernel's launch count and tensor-core launch count to 0;
    returns a reader of the counts (``<name>`` and ``<name>_tensor_core``).
    A wrapper counts only the launches of its kernel, so a CPU run reads 0."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        fn.tensor_core_launches = 0

    def read() -> Dict[str, int]:
        counts = {name: fn.launches for name, fn in wrappers.items()}
        counts.update({f"{name}_tensor_core": fn.tensor_core_launches
                       for name, fn in wrappers.items()})
        return counts

    return read


# ---------------------------------------------------------------------------
# models: the tiny widths, the full ones, and their files
# ---------------------------------------------------------------------------


def encoder_config(backend: str, tiny: bool = False):
    """The encoder config a tool builds: the published widths
    (CLIP ViT-B/32; SigLIP2-B/16-224; ViT-B/16 + BERT-base with the
    checkpoint-level projection of 512 that the fusion head reads), or with
    ``tiny`` two-layer towers of width 64 (224 px images in 32 px patches)."""
    from multimodal_content_moderation_tpu_torch.models import clip, generic, siglip

    tower = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    configs = {
        "clip": (clip.CLIPConfig.base_patch32, lambda: clip.CLIPConfig(
            text=clip.CLIPTextConfig(**tower), vision=clip.CLIPVisionConfig(**tower),
            projection_dim=64)),
        "siglip": (siglip.SigLIPConfig.base_patch16_224, lambda: siglip.SigLIPConfig(
            text=siglip.SigLIPTextConfig(vocab_size=1000, projection_size=64, **tower),
            vision=siglip.SigLIPVisionConfig(patch_size=32, **tower))),
        "generic": (lambda: generic.GenericDualConfig(projection_dim=512),
                    lambda: generic.GenericDualConfig(
            text=generic.GenericTextConfig(vocab_size=1000, max_positions=128, **tower),
            vision=generic.GenericVisionConfig(patch_size=32, **tower), projection_dim=64)),
    }
    return configs[backend][tiny]()


def hf_features(out) -> torch.Tensor:
    """A ``transformers`` ``get_text_features`` / ``get_image_features``
    result as the features tensor: transformers 4 returns the tensor itself,
    transformers 5 a ``BaseModelOutputWithPooling`` whose ``pooler_output``
    holds it."""
    return out if isinstance(out, torch.Tensor) else out.pooler_output


def hf_clip_config(cfg) -> dict:
    """The ``config.json`` of a CLIP encoder directory (a ``CLIPConfig``'s
    dimensions, in Hugging Face's names; BOS is the id before EOS)."""
    t, v = cfg.text, cfg.vision
    return {
        "model_type": "clip",
        "projection_dim": cfg.projection_dim,
        "text_config": {
            "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "intermediate_size": t.intermediate_size,
            "max_position_embeddings": t.max_positions, "eos_token_id": t.eos_token_id,
            "bos_token_id": t.eos_token_id - 1, "hidden_act": t.hidden_act,
            "layer_norm_eps": t.layer_norm_eps,
        },
        "vision_config": {
            "hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads, "intermediate_size": v.intermediate_size,
            "image_size": v.image_size, "patch_size": v.patch_size,
            "num_channels": v.num_channels, "hidden_act": v.hidden_act,
            "layer_norm_eps": v.layer_norm_eps,
        },
    }


def hf_siglip_config(cfg) -> dict:
    """The ``config.json`` of a SigLIP encoder directory (a
    ``SigLIPConfig``'s dimensions, in Hugging Face's names)."""
    t, v = cfg.text, cfg.vision
    return {
        "model_type": "siglip",
        "text_config": {
            "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "intermediate_size": t.intermediate_size,
            "max_position_embeddings": t.max_positions, "projection_size": t.projection_size,
            "hidden_act": t.hidden_act, "layer_norm_eps": t.layer_norm_eps,
        },
        "vision_config": {
            "hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads, "intermediate_size": v.intermediate_size,
            "image_size": v.image_size, "patch_size": v.patch_size,
            "num_channels": v.num_channels, "hidden_act": v.hidden_act,
            "layer_norm_eps": v.layer_norm_eps,
        },
    }


# the words of the synthetic SigLIP vocabulary, before its filler entries
SIGLIP_WORDS = ["<unk>", "<pad>", "hate", "love", "people", "you", "stop", "go", "bad",
                "good"]


def write_siglip_encoder_dir(directory: str, cfg) -> str:
    """A SigLIP encoder dir without weights: the ``config.json`` of ``cfg``,
    a WordLevel ``tokenizer.json`` of its vocabulary size (``SIGLIP_WORDS``,
    then ``fill<i>`` entries; lowercase, split on whitespace), ``<pad>`` as
    the pad token, and SigLIP's 0.5 / 0.5 preprocessor config."""
    from multimodal_content_moderation_tpu_torch.data.images import SIGLIP_MEAN, SIGLIP_STD

    os.makedirs(directory)
    vocab = {w: i for i, w in enumerate(SIGLIP_WORDS)}
    i = 0
    while len(vocab) < cfg.text.vocab_size:
        vocab.setdefault(f"fill{i}", len(vocab))
        i += 1
    size = cfg.vision.image_size
    files = {
        "config.json": hf_siglip_config(cfg),
        "tokenizer.json": {
            "version": "1.0", "normalizer": {"type": "Lowercase"},
            "pre_tokenizer": {"type": "Whitespace"},
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
            "added_tokens": [], "post_processor": None, "decoder": None,
        },
        "tokenizer_config.json": {"pad_token": "<pad>"},
        "preprocessor_config.json": {"size": {"height": size, "width": size},
                                     "image_mean": list(SIGLIP_MEAN),
                                     "image_std": list(SIGLIP_STD)},
    }
    for name, obj in files.items():
        with open(os.path.join(directory, name), "w") as f:
            json.dump(obj, f)
    return directory


def write_encoder_weights(model, directory: str) -> str:
    """``directory/model.safetensors``: ``model``'s backbone in its Hugging
    Face encoder's layout (``models/export.encoder_state_dict``)."""
    from multimodal_content_moderation_tpu_torch.models import convert, export

    return convert.write_safetensors(export.encoder_state_dict(model),
                                     os.path.join(directory, "model.safetensors"))


def write_clip_encoder_dir(directory: str, hf: Optional[dict] = None) -> str:
    """A CLIP encoder dir as a user downloads it, without weights (the train
    CLI then keeps the model's seeded random init): the ``config.json``
    ``hf`` (default: ``hf_clip_config`` of ViT-B/32), a synthetic BPE
    vocabulary of its size (49,408 entries at ViT-B/32) and the
    preprocessor config."""
    from multimodal_content_moderation_tpu_torch.data.images import CLIP_MEAN, CLIP_STD
    from multimodal_content_moderation_tpu_torch.models.clip import CLIPConfig
    from multimodal_content_moderation_tpu_torch.testdata import write_clip_bpe

    hf = hf or hf_clip_config(CLIPConfig.base_patch32())
    text = hf["text_config"]
    os.makedirs(directory)
    vocab = write_clip_bpe(directory, text["vocab_size"], seed=0)
    if vocab["<|endoftext|>"] != text["eos_token_id"]:
        raise ValueError("the synthetic vocabulary's EOS id differs from the config's")
    size = hf["vision_config"]["image_size"]
    for name, obj in (("config.json", hf),
                      ("preprocessor_config.json", {
                          "size": {"shortest_edge": size},
                          "crop_size": {"height": size, "width": size},
                          "image_mean": list(CLIP_MEAN), "image_std": list(CLIP_STD)})):
        with open(os.path.join(directory, name), "w") as f:
            json.dump(obj, f)
    return directory


def write_reference_checkpoint(model, directory: str, inference: dict) -> str:
    """A reference-format checkpoint of a CLIP ``model``: an encoder dir
    (``write_clip_encoder_dir``) holding ``model.safetensors``
    (``models/export.py``) and ``inference_config.json`` (``inference``
    over the fusion defaults). The JAX tools write an Orbax run directory
    here, which the port refuses; this is the layout it reads."""
    from multimodal_content_moderation_tpu_torch.models import export

    write_clip_encoder_dir(directory, hf_clip_config(model.encoder_config))
    export.export_safetensors(model, os.path.join(directory, "model.safetensors"))
    cfg = {"backend": "clip", "head": "fusion", "fusion_dim": model.fusion_dim,
           "class_names": CLASSES, "thresholds": [0.5] * len(CLASSES),
           "max_text_length": model.encoder_config.text.max_positions, **inference}
    with open(os.path.join(directory, "inference_config.json"), "w") as f:
        json.dump(cfg, f)
    return directory


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------


def sub_seed(seed: int, k: int) -> int:
    """The seed of the k-th input of a run made from ``seed``: ``k`` itself
    at seed 0, which is what the JAX tools draw."""
    return seed * 100_000 + k


def make_ids(seed: int, batch: int, seq: int, vocab: int, eos: int,
             eos_pos: int = 30) -> np.ndarray:
    """[batch, seq] int32 token ids in [1, vocab - 2) with EOS at ``eos_pos``
    (the JAX bench's ``make_ids``)."""
    g = np.random.default_rng(seed)
    ids = g.integers(1, vocab - 2, size=(batch, seq)).astype(np.int32)
    ids[:, eos_pos] = eos
    return ids


def crops(g: np.random.Generator, batch: int, size: int) -> np.ndarray:
    """[batch, size, size, 3] uint8 crops."""
    return g.integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8)


def write_byte_bpe(directory: str) -> str:
    """Byte-level BPE assets with no merges (the JAX bench's): the 256 byte
    symbols, their ``</w>`` forms, ``<|startoftext|>`` and
    ``<|endoftext|>``. The tokenizer's machinery runs in full; tweet-length
    text costs what it costs with real merges."""
    from multimodal_content_moderation_tpu_torch.data.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = {}
    for ch in symbols:
        vocab[ch] = len(vocab)
    for ch in symbols:
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return directory


def fixture_jpegs() -> Dict[str, bytes]:
    """{name: bytes} of the committed JPEG fixtures that decode (the
    corrupt one left out), in name order."""
    from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures, pil_crops

    return {name: path.read_bytes() for name, path in jpeg_fixtures().items()
            if pil_crops(name) is not None}


def fixture_payloads() -> List[str]:
    """The decodable JPEG fixtures as base64 strings (request payloads)."""
    return [base64.b64encode(b).decode() for b in fixture_jpegs().values()]


def write_e2e_csv(root: str, rows: int) -> str:
    """``root/test.csv`` of ``rows`` tweet-length rows whose images are the
    committed JPEG fixtures in turn, copied to ``root/img``; returns the
    CSV's path."""
    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir, exist_ok=True)
    names = []
    for name, data in fixture_jpegs().items():
        with open(os.path.join(img_dir, f"{name}.jpg"), "wb") as f:
            f.write(data)
        names.append(f"{name}.jpg")
    lines = ["text,image_path,labels"]
    for r in range(rows):
        lines.append(f"offensive tweet number {r} with several words,"
                     f"{names[r % len(names)]},racist")
    path = os.path.join(root, "test.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def e2e_dataset(root: str, csv_path: str, seq: int, image_size: int, cache: bool,
                backend: str = "native_scaled"):
    """The CSV of ``write_e2e_csv`` as a ``CSVDataset``: the byte-level BPE,
    ``backend`` decode to uint8 crops, and with ``cache`` the decode-once
    pixel cache under ``root/cache``."""
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import (
        CLIP_MEAN,
        CLIP_STD,
        ImagePreprocessor,
    )
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer

    tok_dir = os.path.join(root, "tokenizer")
    if not os.path.exists(os.path.join(tok_dir, "vocab.json")):
        write_byte_bpe(tok_dir)
    return CSVDataset(
        csv_path, os.path.join(root, "img"), load_tokenizer(tok_dir),
        ImagePreprocessor(image_size, image_size, CLIP_MEAN, CLIP_STD, output="uint8_hwc",
                          backend=backend),
        seq, class_names=CLASSES, cache_dir=os.path.join(root, "cache") if cache else None,
    )


# ---------------------------------------------------------------------------
# the profiler's device time by kernel family
# ---------------------------------------------------------------------------

# device-kernel name fragments -> the layer they belong to, first match wins
KERNEL_GROUPS = [
    ("attention_nhd_bwd", ("attention_nhd_bwd",)),
    ("attention_nhd", ("attention_nhd",)),
    ("flash_attention", ("flash_attention",)),
    ("attention_small", ("attention_small",)),
    ("patch_embed_u8", ("patch_embed_u8",)),
    ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma", "cublas")),
    ("layer_norm", ("layer_norm",)),
    ("dtype casts and copies", ("copy",)),
    ("other elementwise", ("elementwise", "reduce", "index", "cat")),
]
NOT_MEASURED = "not measured (the profiler reported no device time)"


def group_device_time(prof, wall_ms: float, n_batches: int):
    """Device time per batch by kernel group from a finished
    ``torch.profiler`` run (``key_averages()``, named ranges left out), the
    share of ``wall_ms``
    the device was busy, and the top kernels; ``NOT_MEASURED`` where the
    profiler reports no device time (a CPU run, or a trace without CUPTI)."""
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
        # a named range (utils/profiling.annotate) spans kernels; it is none
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms == 0:
        return NOT_MEASURED
    rows.sort(key=lambda r: -r[1])
    groups: Dict[str, float] = {}
    for name, ms, _ in rows:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms / n_batches
    return {
        "wall_ms_per_batch": wall_ms / n_batches,
        "device_busy_ms_per_batch": busy_ms / n_batches,
        "device_busy_share_of_wall": busy_ms / wall_ms,
        "groups_ms_per_batch": groups,
        "top_kernels_ms_per_batch": [
            [name[:90], ms / n_batches, count // n_batches] for name, ms, count in rows[:12]
        ],
    }


def device_time_breakdown(run: Callable[[], object], n_batches: int,
                          trace_dir: Optional[str] = None):
    """``group_device_time`` of ``run()`` under ``torch.profiler`` (CPU and
    CUDA activity), timed from a synchronise to a synchronise; with
    ``trace_dir`` the run's Chrome trace is written there too
    (``utils/profiling.trace``)."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_content_moderation_tpu_torch.utils.profiling import trace

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    ctx = (trace(trace_dir) if trace_dir else
           profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else [])))
    with ctx as prof:
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return group_device_time(prof, wall_ms, n_batches)


def host_cpus() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - not Linux
        return os.cpu_count() or 1


def warn(tool: str, msg: str) -> None:
    print(f"[{tool}] {msg}", file=sys.stderr, flush=True)
