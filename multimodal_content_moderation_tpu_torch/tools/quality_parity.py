"""Quality-parity harness: fine-tune an oracle and the port's model on the
SAME dataset and compare F1/ROC (the JAX package's ``tools/quality_parity.py``).

This is the machinery that demonstrates the BASELINE quality target
(F1-macro/ROC-AUC within +-0.005 of 0.569/0.783, reference
runs/clip_mtl_mmhshateful/test_metrics.json) the moment real MMHS150K assets
are mounted; the CPU tests exercise it on synthetic fixtures, and
``chip_smoke.py`` phase 14 runs it at full width on the card.

Two modes:
- ``--mode locked`` (default): identical init (the oracle's weights converted
  into the port's model), identical data order, dropout off, same AdamW
  hyperparameters. Differences are then pure numerics, so per-step losses
  and final metrics must agree tightly.
- ``--mode independent``: each side trains from its own head init with
  dropout on (the realistic comparison; metric deltas reflect seed noise,
  not bugs). The encoders start from the same weights on both sides.

Two oracles (``--oracle``):
- ``reference`` (default): the reference-shaped Hugging Face model
  (``--head fusion`` = src/models/fusion.py:55-229; ``--head mtl`` =
  src/models/multitask.py:16-227 incl. hidden task heads) trained with
  ``torch.optim.AdamW`` + BCE, the reference's effective configuration
  (single LR: its two-LR knob was cosmetic, scripts/train.py:273). Needs
  ``transformers``; without it the tool exits non-zero and never switches
  oracle on its own.
- ``fp32``: the port's own model at the parity configuration: fp32
  parameters and compute, the plain attention core, normalised fp32 pixels
  (no ``patch_embed_u8``), fp32 Adam moments, TF32 off. Its encoder starts
  from the encoder directory's weights and its head from the reference
  head's layout and init distribution, drawn after ``torch.manual_seed``.
  It runs on the device of the side under test; the CPU tests hold it to
  the ``reference`` oracle.

Both sides read the same ``CSVDataset`` batches in the same order. ``--fast``
trains the port's side with the production recipe while the oracle stays
fp32: the u8 wire (uint8 crops, the normalisation folded into the
``patch_embed_u8`` kernel), bf16 compute and attention scores with the
attention kernels in both passes (their plain versions on the CPU), bf16
Adam moments, and ``text_fit`` (CLIP's static text width cut to the data;
exact for a causal tower pooled at the first EOS). The band check then
proves that the fast recipe holds the quality band, not just the fp32 path.

``--reference_bf16`` (with ``--oracle reference``) also trains the reference
model itself in bf16 mixed precision from the oracle's start and data order:
a bf16 copy computes the forward and backward, and its gradients step the
fp32 weights. It shares no code with the port, so it witnesses what bf16
compute alone does to a configuration, beside what the fast recipe does.

Prints the report (indented JSON); exits 0 when |delta f1_macro| and
|delta roc_macro| are within ``--tolerance``.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from multimodal_content_moderation_tpu_torch.tools import _common as c

# the port side's recipes: compute (and attention score) dtype, attention
# core, image wire, Adam moments' dtype (None: fp32), text_fit
PARITY = {"compute_dtype": "float32", "attention_impl": "xla", "wire": "f32",
          "accumulator_dtype": None, "text_fit": False}
FAST = {"compute_dtype": "bfloat16", "attention_impl": "pallas", "wire": "u8",
        "accumulator_dtype": "bfloat16", "text_fit": True}


# ---------------------------------------------------------------------------
# the reference oracle (Hugging Face towers; transformers imported here only)
# ---------------------------------------------------------------------------


def add_fusion_head(module, d: int, num_labels: int, fusion_dim: int) -> None:
    """The reference fusion head's modules on ``module``, in its
    construction order (which fixes the order of the init draws)."""
    from torch import nn

    module.proj_t = nn.Linear(d, fusion_dim)
    module.proj_i = nn.Linear(d, fusion_dim)
    module.g_t = nn.Linear(fusion_dim, fusion_dim)
    module.g_i = nn.Linear(fusion_dim, fusion_dim)
    module.gate = nn.Linear(fusion_dim * 2 + 2, fusion_dim)
    module.ln_fused = nn.LayerNorm(fusion_dim)
    module.cls = nn.Sequential(
        nn.LayerNorm(fusion_dim * 5),
        nn.Linear(fusion_dim * 5, fusion_dim),
        nn.GELU(),
        nn.Dropout(0.2),
        nn.Linear(fusion_dim, num_labels),
    )


def add_mtl_head(module, tdim: int, idim: int, num_tasks: int, fusion_dim: int,
                 head_hidden_dim: int) -> None:
    """The reference multi-task head's modules on ``module``, in its
    construction order."""
    from torch import nn

    module.proj_t = nn.Linear(tdim, fusion_dim)
    module.proj_i = nn.Linear(idim, fusion_dim)
    module.g_t = nn.Linear(fusion_dim, fusion_dim)
    module.g_i = nn.Linear(fusion_dim, fusion_dim)
    module.gate = nn.Linear(fusion_dim * 2 + 2, fusion_dim)
    module.shared_head = nn.Sequential(
        nn.Dropout(0.2), nn.Linear(fusion_dim, fusion_dim), nn.GELU(), nn.Dropout(0.2),
    )

    def make_head():
        if head_hidden_dim > 0:
            return nn.Sequential(
                nn.Linear(fusion_dim, head_hidden_dim), nn.GELU(),
                nn.Dropout(0.1), nn.Linear(head_hidden_dim, 1),
            )
        return nn.Linear(fusion_dim, 1)

    module.heads = nn.ModuleList([make_head() for _ in range(num_tasks)])


def _fuse(tp, vp, tpres, ipres, g_t, g_i, gate):
    """The reference's tanh-gated fusion with its three-way fallback."""
    zt, zi = torch.tanh(g_t(tp)), torch.tanh(g_i(vp))
    presence = torch.stack([tpres, ipres], dim=1)
    g = torch.sigmoid(gate(torch.cat([tp, vp, presence], dim=1)))
    return torch.where(
        (ipres < 0.5).unsqueeze(1),
        zt,
        torch.where((tpres < 0.5).unsqueeze(1), zi, g * zt + (1 - g) * zi),
    )


def _import_transformers():
    try:
        import transformers
    except ImportError:
        raise SystemExit(
            "quality_parity: --oracle reference needs the transformers package, which is "
            "not installed here; pass --oracle fp32 for the port's own fp32 oracle"
        ) from None
    return transformers


def build_torch_fusion(
    encoder_dir: str, num_labels: int, fusion_dim: int, seed: int,
    backend: str = "clip",
):
    """Reference-shaped torch fusion classifier over a local HF encoder dir.

    ``backend="clip"`` mirrors the reference's CLIP path
    (``CLIPModel.get_text/image_features``); ``backend="siglip"`` mirrors its
    "auto" path (AutoModel submodule pooler outputs: text pooler head,
    vision MAP head — reference src/models/fusion.py:100-111)."""
    import torch.nn.functional as F
    from torch import nn

    transformers = _import_transformers()

    class TorchFusion(nn.Module):
        def __init__(self):
            super().__init__()
            if backend == "clip":
                cfg = transformers.CLIPConfig.from_pretrained(encoder_dir)
                self.backbone = transformers.CLIPModel.from_pretrained(encoder_dir)
                d = cfg.projection_dim
            else:
                self.backbone = transformers.SiglipModel.from_pretrained(encoder_dir)
                d = self.backbone.config.text_config.hidden_size
            add_fusion_head(self, d, num_labels, fusion_dim)

        def forward(self, ids, mask, px, tpres, ipres):
            if backend == "clip":
                t = c.hf_features(self.backbone.get_text_features(input_ids=ids,
                                                                  attention_mask=mask))
                v = c.hf_features(self.backbone.get_image_features(pixel_values=px))
            else:
                t = self.backbone.text_model(input_ids=ids, attention_mask=mask).pooler_output
                v = self.backbone.vision_model(pixel_values=px).pooler_output
            t = F.normalize(t, dim=-1) * tpres.unsqueeze(1)
            v = F.normalize(v, dim=-1) * ipres.unsqueeze(1)
            tp, vp = self.proj_t(t), self.proj_i(v)
            fused = self.ln_fused(_fuse(tp, vp, tpres, ipres, self.g_t, self.g_i, self.gate))
            feat = torch.cat([fused, tp, vp, torch.abs(tp - vp), tp * vp], dim=1)
            return self.cls(feat)

    torch.manual_seed(seed)
    return TorchFusion()


def build_torch_mtl(
    encoder_dir: str, num_tasks: int, fusion_dim: int, head_hidden_dim: int,
    seed: int, backend: str = "clip",
):
    """Reference-shaped torch MTL classifier (pooler outputs + shared trunk +
    per-task heads, src/models/multitask.py). ``backend="clip"`` uses the
    separate tower_txt/tower_img layout; ``backend="siglip"`` the shared
    AutoModel backbone layout (multitask.py:130-154)."""
    from torch import nn

    transformers = _import_transformers()

    class TorchMTL(nn.Module):
        def __init__(self):
            super().__init__()
            if backend == "clip":
                cfg = transformers.CLIPConfig.from_pretrained(encoder_dir)
                self.tower_txt = transformers.CLIPTextModel.from_pretrained(encoder_dir)
                self.tower_img = transformers.CLIPVisionModel.from_pretrained(encoder_dir)
                tdim = cfg.text_config.hidden_size
                idim = cfg.vision_config.hidden_size
            else:
                self.backbone = transformers.SiglipModel.from_pretrained(encoder_dir)
                tdim = self.backbone.config.text_config.hidden_size
                idim = self.backbone.config.vision_config.hidden_size
            add_mtl_head(self, tdim, idim, num_tasks, fusion_dim, head_hidden_dim)

        def forward(self, ids, mask, px, tpres, ipres):
            if backend == "clip":
                tfeat = self.tower_txt(input_ids=ids, attention_mask=mask).pooler_output
                vfeat = self.tower_img(pixel_values=px).pooler_output
            else:
                tfeat = self.backbone.text_model(
                    input_ids=ids, attention_mask=mask).pooler_output
                vfeat = self.backbone.vision_model(pixel_values=px).pooler_output
            tp, vp = self.proj_t(tfeat), self.proj_i(vfeat)
            fused = _fuse(tp, vp, tpres, ipres, self.g_t, self.g_i, self.gate)
            shared = self.shared_head(fused)
            return torch.stack([h(shared).squeeze(-1) for h in self.heads], dim=1)

    torch.manual_seed(seed)
    return TorchMTL()


# ---------------------------------------------------------------------------
# data order and the two training loops
# ---------------------------------------------------------------------------


def epoch_orders(n: int, epochs: int, seed: int):
    return [np.random.default_rng(seed + e).permutation(n) for e in range(epochs)]


def batches_for(ds, order, batch_size):
    yield from ds.batches(batch_size, drop_last=True, indices=order)


def _timed_side(fn):
    """(fn's result, seconds, launches) of one side's run."""
    counts = c.launch_counter()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, counts()


def train_reference(model, train_ds, val_ds, orders, batch_size, lr, wd, dropout_off,
                    device, compute_dtype="float32"):
    """The reference oracle: ``torch.optim.AdamW`` + BCE over the HF model.
    ``compute_dtype="bfloat16"`` trains it in mixed precision: a bf16 copy
    computes the forward and backward, and its gradients, cast to fp32, step
    the fp32 weights (fp32 Adam moments), which the copy then takes up."""
    import torch.nn.functional as F

    model.to(device)
    dt = getattr(torch, compute_dtype)
    work = model if dt == torch.float32 else copy.deepcopy(model).to(dt)
    work.eval() if dropout_off else work.train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=wd)
    pairs = [] if work is model else list(zip(model.parameters(), work.parameters()))

    def args(b):
        return (torch.tensor(b["input_ids"].astype(np.int64), device=device),
                torch.tensor(b["attention_mask"].astype(np.int64), device=device),
                torch.tensor(b["pixel_values"], device=device, dtype=dt),
                torch.tensor(b["text_present"], device=device, dtype=dt),
                torch.tensor(b["image_present"], device=device, dtype=dt))

    losses = []
    for order in orders:
        for b in batches_for(train_ds, order, batch_size):
            opt.zero_grad()
            loss = F.binary_cross_entropy_with_logits(
                work(*args(b)).float(), torch.tensor(b["labels"], device=device))
            loss.backward()
            for p, q in pairs:
                p.grad, q.grad = None if q.grad is None else q.grad.float(), None
            opt.step()
            with torch.no_grad():
                for p, q in pairs:
                    q.copy_(p)
            losses.append(float(loss))
    work.eval()
    all_logits, all_labels = [], []
    with torch.no_grad():
        for b in batches_for(val_ds, np.arange(len(val_ds)), batch_size):
            all_logits.append(work(*args(b)).float().cpu().numpy())
            all_labels.append(b["labels"])
    return losses, np.concatenate(all_logits), np.concatenate(all_labels)


def train_port(model, train_ds, val_ds, orders, batch_size, lr, wd, dropout_off, seed,
               feed=None):
    """The port's side (also the ``fp32`` oracle): ``make_train_step`` +
    ``AdamW`` with one learning rate, no clipping and a constant schedule
    (optax.adamw's update). ``feed`` (dict or None: fp32 pixels, fp32
    moments) holds ``patch_size`` (the u8 wire), ``text_width``
    (``text_fit``) and ``accumulator_dtype`` (the Adam moments'). Returns
    (losses, val logits, val labels, eval_val), ``eval_val(model)`` giving
    another model's val logits."""
    from multimodal_content_moderation_tpu_torch.ops.cuda_image import extract_patches_u8
    from multimodal_content_moderation_tpu_torch.training.loop import make_train_step
    from multimodal_content_moderation_tpu_torch.training.optim import AdamW

    device = model.device
    opt = AdamW(dict(model.named_parameters()), lr_encoder=lr, lr_head=lr, weight_decay=wd,
                max_grad_norm=0.0, warmup_ratio=0.0, schedule="constant",
                accumulator_dtype=(feed or {}).get("accumulator_dtype"))
    gen = None if dropout_off else torch.Generator(device=device).manual_seed(seed)
    step = make_train_step(model, opt, generator=gen)
    patch_size = (feed or {}).get("patch_size")
    text_w = (feed or {}).get("text_width")

    def prep(b, with_labels=True):
        out = {k: b[k] for k in ("input_ids", "attention_mask", "pixel_values",
                                 "text_present", "image_present", "labels")
               if with_labels or k != "labels"}
        if patch_size:
            out["patches_u8"] = extract_patches_u8(out.pop("pixel_values"), patch_size)
        if text_w and text_w < out["input_ids"].shape[1]:
            out["input_ids"] = out["input_ids"][:, :text_w]
            out["attention_mask"] = out["attention_mask"][:, :text_w]
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in out.items()}

    losses = []
    for order in orders:
        for b in batches_for(train_ds, order, batch_size):
            losses.append(float(step(prep(b))))

    def eval_val(m):
        all_logits, all_labels = [], []
        with torch.no_grad():
            for b in batches_for(val_ds, np.arange(len(val_ds)), batch_size):
                all_logits.append(m(prep(b, with_labels=False))["logits"].float().cpu().numpy())
                all_labels.append(b["labels"])
        return np.concatenate(all_logits), np.concatenate(all_labels)

    logits, labels = eval_val(model)
    return losses, logits, labels, eval_val


# ---------------------------------------------------------------------------
# the port's models and the fp32 oracle's initial weights
# ---------------------------------------------------------------------------


def reference_head_state(head: str, backend: str, enc_cfg, num_labels: int,
                         fusion_dim: int, head_hidden_dim: int, seed: int) -> dict:
    """The reference head's state dict for the encoder's feature widths,
    drawn by ``nn.Linear``'s own init after ``torch.manual_seed(seed)`` (the
    reference's layout and distribution; not its exact draw, since the HF
    backbone the reference builds first consumes the generator too)."""
    from torch import nn

    from multimodal_content_moderation_tpu_torch.models.fusion import (
        config_field,
        fusion_feature_dim,
    )

    module = nn.Module()
    torch.manual_seed(seed)
    if head == "mtl":
        add_mtl_head(module, enc_cfg.text.hidden_size, enc_cfg.vision.hidden_size, num_labels,
                     fusion_dim, head_hidden_dim)
    else:
        add_fusion_head(module, fusion_feature_dim(backend, **{config_field(backend): enc_cfg}),
                        num_labels, fusion_dim)
    return module.state_dict()


def encoder_reference_state(encoder_dir: str, head: str, backend: str) -> dict:
    """The encoder directory's weights under the reference model's names:
    ``backbone.*``, or CLIP's bare ``tower_txt.*`` / ``tower_img.*`` towers
    of the multi-task model."""
    from multimodal_content_moderation_tpu_torch.models import model_io

    sd = model_io._find_state_dict(encoder_dir)
    if sd is None:
        raise FileNotFoundError(f"{encoder_dir}: no encoder weights (model.safetensors or "
                                "pytorch_model.bin)")
    if head == "mtl" and backend == "clip":
        out = {f"tower_txt.{k}": v for k, v in sd.items() if k.startswith("text_model.")}
        out.update({f"tower_img.{k}": v for k, v in sd.items()
                    if k.startswith("vision_model.")})
        return out
    return {f"backbone.{k}": v for k, v in sd.items()}


class PortModels:
    """Builds the port's models of one configuration: from a reference
    state dict (``convert.*_from_torch``), or seeded."""

    def __init__(self, head, backend, enc_cfg, num_labels, fusion_dim, head_hidden_dim,
                 device):
        from multimodal_content_moderation_tpu_torch.models.fusion import config_field

        self.head, self.backend, self.device = head, backend, device
        self.num_labels, self.fusion_dim = num_labels, fusion_dim
        self.head_hidden_dim = head_hidden_dim
        self.cfg_kw = {config_field(backend): enc_cfg}
        self.conv_kw = {config_field(backend).replace("_config", "_cfg"): enc_cfg}

    def from_state(self, sd: dict):
        from multimodal_content_moderation_tpu_torch.models import convert
        from multimodal_content_moderation_tpu_torch.models.fusion import FusionModel
        from multimodal_content_moderation_tpu_torch.models.multitask import MultiTaskModel

        sd = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
        if self.head == "mtl":
            params = convert.mtl_model_from_torch(sd, self.backend, self.num_labels,
                                                  **self.conv_kw)
            model = MultiTaskModel(params, self.backend, num_tasks=self.num_labels,
                                   fusion_dim=self.fusion_dim,
                                   head_hidden_dim=self.head_hidden_dim, **self.cfg_kw)
        else:
            params = convert.fusion_model_from_torch(sd, self.backend, **self.conv_kw)
            model = FusionModel(params, self.backend, num_labels=self.num_labels,
                                fusion_dim=self.fusion_dim, **self.cfg_kw)
        return model.to(self.device)

    def seeded(self, seed: int):
        from multimodal_content_moderation_tpu_torch.models import model_io

        return model_io.build_model(
            self.head, self.backend, list(range(self.num_labels)), self.fusion_dim,
            seed=seed, device=self.device, head_hidden_dim=self.head_hidden_dim,
            **self.cfg_kw)


def configured(model, recipe: dict):
    """``model`` with the towers' compute (and score) dtype and attention
    core of ``recipe``."""
    from multimodal_content_moderation_tpu_torch.models import model_io

    return model_io.with_performance_options(
        model, compute_dtype=recipe["compute_dtype"], scores_dtype=recipe["compute_dtype"],
        attention_impl=recipe["attention_impl"])


def _with_backbone(model, backbone_of):
    """``model`` with its backbone's values copied from ``backbone_of``'s."""
    with torch.no_grad():
        src = backbone_of.backbone.state_dict()
        for name, t in model.backbone.state_dict().items():
            t.copy_(src[name])
    return model


def _metrics(d):
    return {k: float(v) for k, v in d.items()}


def image_backend() -> str:
    """PIL where it imports, else the native decoder (the card machine has
    no PIL)."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "native"
    return "pil"


def run(
    encoder_dir: str,
    train_csv: str,
    val_csv: str,
    image_root: str = "",
    class_names=None,
    mode: str = "locked",
    epochs: int = 2,
    batch_size: int = 8,
    lr: float = 1e-3,
    weight_decay: float = 0.01,
    fusion_dim: int = 32,
    max_text_length: int = 77,
    seed: int = 0,
    head: str = "fusion",
    head_hidden_dim: int = 0,
    backend: str = "clip",
    fast: bool = False,
    int8_eval: bool = False,
    oracle: str = "reference",
    device="cuda",
    init_state=None,
    reference_bf16: bool = False,
) -> dict:
    """The report of one comparison (module docstring). ``init_state`` (a
    reference-format state dict) is where both sides start instead of the
    oracle's own init (locked mode). ``reference_bf16`` adds the
    ``reference_bf16`` block: the reference model trained in bf16 from the
    oracle's start (needs ``oracle="reference"``)."""
    from multimodal_content_moderation_tpu_torch.cli.common import image_stats_from_dir
    from multimodal_content_moderation_tpu_torch.data.dataset import CSVDataset
    from multimodal_content_moderation_tpu_torch.data.images import ImagePreprocessor
    from multimodal_content_moderation_tpu_torch.data.tokenizer import load_tokenizer
    from multimodal_content_moderation_tpu_torch.models import model_io
    from multimodal_content_moderation_tpu_torch.training.metrics import (
        make_compute_metrics_multi,
    )

    if oracle not in ("reference", "fp32"):
        raise ValueError(f"oracle {oracle!r}: want 'reference' or 'fp32'")
    if reference_bf16 and oracle != "reference":
        raise ValueError("reference_bf16 trains the reference model: it needs "
                         "oracle='reference'")
    if oracle == "reference":
        _import_transformers()
    dev = c.open_device(str(device), "quality_parity")
    card = c.card_line(dev)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        class_names = class_names or c.CLASSES
        tokenizer = load_tokenizer(encoder_dir)
        (H, W), mean, std = image_stats_from_dir(encoder_dir, backend)
        decode = image_backend()

        def datasets(output):
            pp = ImagePreprocessor(H, W, mean, std, output=output, backend=decode)
            return [CSVDataset(csv, image_root, tokenizer, pp, max_text_length,
                               class_names=class_names) for csv in (train_csv, val_csv)]

        train_ds, val_ds = datasets("float_nchw")
        orders = epoch_orders(len(train_ds), epochs, seed)
        enc_cfg = model_io.load_encoder_config(encoder_dir, backend)
        models = PortModels(head, backend, enc_cfg, len(class_names), fusion_dim,
                            head_hidden_dim, dev)
        dropout_off = mode == "locked"

        # the oracle, and the state the port's side starts from
        if oracle == "reference":
            ref = (build_torch_mtl(encoder_dir, len(class_names), fusion_dim, head_hidden_dim,
                                   seed, backend=backend) if head == "mtl"
                   else build_torch_fusion(encoder_dir, len(class_names), fusion_dim, seed,
                                           backend=backend))
            if init_state is not None:
                ref.load_state_dict(init_state)
            start = models.from_state(ref.state_dict())
            witness = copy.deepcopy(ref) if reference_bf16 else None
        else:
            sd = init_state
            if sd is None:
                sd = {**encoder_reference_state(encoder_dir, head, backend),
                      **reference_head_state(head, backend, enc_cfg, len(class_names),
                                             fusion_dim, head_hidden_dim, seed)}
            ref = configured(models.from_state(sd), PARITY)
            start = models.from_state(sd)
        if mode == "locked":
            port = start
        else:
            port = _with_backbone(models.seeded(seed + 1), start)

        recipe = FAST if fast else PARITY
        feed = {"accumulator_dtype": recipe["accumulator_dtype"]}
        p_train_ds, p_val_ds = train_ds, val_ds
        if recipe["wire"] == "u8":
            # uint8 crops, the normalisation folded into the patch embed
            p_train_ds, p_val_ds = datasets("uint8_hwc")
            feed["patch_size"] = enc_cfg.vision.patch_size
            port = port.replace(image_mean=tuple(float(m) for m in mean),
                                image_std=tuple(float(s) for s in std))
        if recipe["text_fit"] and backend == "clip":  # exact for CLIP (causal + EOS pool)
            longest = max(int(d.attention_mask.sum(axis=1).max(initial=1))
                          for d in (p_train_ds, p_val_ds))
            feed["text_width"] = min(max_text_length, max(8, -(-longest // 8) * 8))
        port = configured(port, recipe)

        if oracle == "reference":
            (o_losses, o_logits, labels), o_s, o_launches = _timed_side(
                lambda: train_reference(ref, train_ds, val_ds, orders, batch_size, lr,
                                        weight_decay, dropout_off, dev))
        else:
            (o_losses, o_logits, labels, _), o_s, o_launches = _timed_side(
                lambda: train_port(ref, train_ds, val_ds, orders, batch_size, lr,
                                   weight_decay, dropout_off, seed))
        (p_losses, p_logits, _, p_eval_val), p_s, p_launches = _timed_side(
            lambda: train_port(port, p_train_ds, p_val_ds, orders, batch_size, lr,
                               weight_decay, dropout_off, seed + 1, feed=feed))

        cm = make_compute_metrics_multi(len(class_names))
        o_metrics = cm((o_logits, labels))
        p_metrics = cm((p_logits, labels))
        trained = len(o_losses) * batch_size
        report = {
            "mode": mode + ("_fast" if fast else ""),
            # "oracle" holds the oracle's metrics, as the JAX report's "torch"
            "oracle_kind": oracle,
            "port_config": describe(recipe, feed.get("text_width")),
            "head": head,
            "backend": backend,
            "steps": len(o_losses),
            "oracle": _metrics(o_metrics),
            "port": _metrics(p_metrics),
            "delta": {k: float(abs(p_metrics[k] - o_metrics[k])) for k in o_metrics},
            "final_loss_oracle": o_losses[-1],
            "final_loss_port": p_losses[-1],
            "max_step_loss_delta": float(
                np.max(np.abs(np.asarray(o_losses) - np.asarray(p_losses)))),
            "max_val_logit_delta": float(np.max(np.abs(o_logits - p_logits)))
            if mode == "locked" else None,
            "losses": {"oracle": o_losses, "port": p_losses},
            "device": card,
            "launches": {"oracle": o_launches, "port": p_launches},
            "wall_s": {"oracle": o_s, "port": p_s},
            "trained_samples_per_s": {"oracle": trained / o_s, "port": trained / p_s},
            "image_backend": decode,
            "seed": seed,
        }
        if reference_bf16:
            report["reference_bf16"] = witness_block(
                _timed_side(lambda: train_reference(
                    witness, train_ds, val_ds, orders, batch_size, lr, weight_decay,
                    dropout_off, dev, compute_dtype="bfloat16")),
                cm, labels, mode, (o_losses, o_logits, o_metrics), (p_losses, p_logits, p_metrics))
        if int8_eval:
            report["int8_mlp"] = int8_block(port, p_eval_val, cm, labels, o_metrics, p_metrics,
                                            p_logits)
        return report
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def describe(recipe: dict, text_width) -> str:
    """The port side's recipe in the words of the JAX report's
    ``jax_config``."""
    if recipe == PARITY:
        return "fp32 parity"
    return f"u8 wire + bf16 compute/scores + bf16 Adam accumulators + text_fit {text_width}"


def witness_block(timed, cm, labels, mode, oracle_side, port_side) -> dict:
    """The ``reference_bf16`` block from the witness's ``_timed_side`` of
    ``train_reference`` and each side's (losses, val logits, metrics): its
    metrics, and its metric, per-step loss and val-logit deltas against the
    oracle and the port's side (the logit deltas in locked mode only)."""
    (losses, logits, _), seconds, launches = timed
    metrics = cm((logits, labels))
    out = {"metrics": _metrics(metrics), "losses": losses, "wall_s": seconds,
           "launches": launches}
    for name, (s_losses, s_logits, s_metrics) in (("oracle", oracle_side),
                                                  ("port", port_side)):
        out[f"delta_vs_{name}"] = {k: float(abs(metrics[k] - s_metrics[k])) for k in metrics}
        out[f"max_step_loss_delta_vs_{name}"] = float(
            np.max(np.abs(np.asarray(losses) - np.asarray(s_losses))))
        out[f"max_val_logit_delta_vs_{name}"] = (
            float(np.max(np.abs(logits - s_logits))) if mode == "locked" else None)
    return out


def int8_block(model, eval_val, cm, labels, o_metrics, p_metrics, p_logits) -> dict:
    """The opt-in int8_mlp eval tier on the trained port model: val logits
    with its encoder's fc1 layers in int8 (``ops/quant.py``; the head and
    the SigLIP MAP head stay as they are), against the oracle's and the
    model's own metrics and logits."""
    from multimodal_content_moderation_tpu_torch.ops.quant import quantize_fc1_layers

    q_model, nq = quantize_fc1_layers(model)
    (i_logits, _), _, launches = _timed_side(lambda: eval_val(q_model))
    i_metrics = cm((i_logits, labels))
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    return {
        "quantized_fc1_layers": nq,
        "metrics": _metrics(i_metrics),
        "delta_vs_oracle": {k: float(abs(i_metrics[k] - o_metrics[k])) for k in o_metrics},
        "delta_vs_port": {k: float(abs(i_metrics[k] - p_metrics[k])) for k in p_metrics},
        "max_val_logit_delta_vs_port": float(np.max(np.abs(i_logits - p_logits))),
        "max_val_prob_delta_vs_port": float(
            np.max(np.abs(sig(i_logits) - sig(p_logits)))),
        "launches": launches,
    }


def add_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags the port adds to the JAX tool's (``--fast`` in place of
    ``--jax_fast``, ``--oracle``, ``--device``) and ``--int8_eval``."""
    ap.add_argument(
        "--fast", action="store_true",
        help="the port's side trains with the production fast recipe (u8 wire + bf16 "
        "compute/scores with the attention kernels + bf16 Adam accumulators + text_fit) "
        "while the oracle stays fp32: proves the fast recipe holds the quality band",
    )
    ap.add_argument(
        "--int8_eval", action="store_true",
        help="also evaluate the trained port model with the opt-in int8_mlp tier "
        "(selective int8 fc1, ops/quant.py) and report its metric / logit deltas",
    )
    ap.add_argument("--oracle", choices=["reference", "fp32"], default="reference",
                    help="reference: the HF reference-shaped model (needs transformers); "
                    "fp32: the port's own model at the fp32 parity configuration")
    ap.add_argument("--reference_bf16", action="store_true",
                    help="also train the reference model itself in bf16 mixed precision "
                    "from the oracle's start and data order (needs --oracle reference): a "
                    "witness of what bf16 compute does that shares no code with the port")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where both sides train; cuda (the default) needs a card")
    return ap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder_dir", required=True)
    ap.add_argument("--train_csv", required=True)
    ap.add_argument("--val_csv", required=True)
    ap.add_argument("--image_root", default="")
    ap.add_argument("--class_names", default="")
    ap.add_argument("--mode", choices=["locked", "independent"], default="locked")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=0.01)
    ap.add_argument("--fusion_dim", type=int, default=32)
    ap.add_argument("--head", choices=["fusion", "mtl"], default="fusion")
    ap.add_argument("--head_hidden_dim", type=int, default=0)
    ap.add_argument("--backend", choices=["clip", "siglip"], default="clip")
    ap.add_argument("--max_text_length", type=int, default=77)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=0.005,
                    help="max allowed |delta| on f1_macro / roc_macro")
    add_args(ap)
    ap.add_argument("--output", default="")
    args = ap.parse_args(argv)
    if args.reference_bf16 and args.oracle != "reference":
        ap.error("--reference_bf16 trains the reference model: it needs --oracle reference")
    names = [n for n in args.class_names.split(",") if n] or None
    report = run(
        args.encoder_dir, args.train_csv, args.val_csv, args.image_root, names,
        args.mode, args.epochs, args.batch_size, args.lr, args.weight_decay,
        args.fusion_dim, args.max_text_length, args.seed,
        head=args.head, head_hidden_dim=args.head_hidden_dim,
        backend=args.backend, fast=args.fast, int8_eval=args.int8_eval,
        oracle=args.oracle, device=args.device, reference_bf16=args.reference_bf16,
    )
    print(json.dumps(report, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if within_band(report, args.tolerance) else 1


def within_band(report: dict, tolerance: float = 0.005) -> bool:
    """|delta f1_macro| and |delta roc_macro| within ``tolerance``."""
    return (report["delta"].get("f1_macro", 1.0) <= tolerance
            and report["delta"].get("roc_macro", 1.0) <= tolerance)


if __name__ == "__main__":
    raise SystemExit(main())
