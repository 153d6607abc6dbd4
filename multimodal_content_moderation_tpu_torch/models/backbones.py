"""The port's model families in one table: everything that differs between
CLIP, SigLIP, the generic towers (a BERT-family text tower beside a ViT),
DeepSeek-V2 and Kimi-Linear (sparse decoders beside SigLIP's vision
tower).

``backbone(name)`` returns a family's ``Backbone``. "auto" is SigLIP's
record, as in the JAX package, for a checkpoint whose inference config kept
it. Every other module asks the record and never compares the name; a model
keeps the name it was given in ``backend``. A family is added as its own
module (config, init, forward, reference layout both ways) and one entry of
``BACKBONES``.

Importing this module builds no kernel, allocates nothing and reads no
file: the records hold functions and constants.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from multimodal_content_moderation_tpu_torch.data.images import (
    CLIP_MEAN,
    CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
)
from multimodal_content_moderation_tpu_torch.models import (
    clip,
    deepseek_v2,
    generic,
    kimi_linear,
    siglip,
)
from multimodal_content_moderation_tpu_torch.models.params import TOP_LEVEL


@dataclasses.dataclass(frozen=True)
class MultiTask:
    """The bare towers the multi-task head pools, and their place in the
    reference multi-task checkpoint."""

    backend: str  # the backend a multi-task model of the family records
    init: Callable  # (generator, cfg, dtype) -> the backbone tree
    from_torch: Callable  # (reference multi-task state dict, cfg) -> the backbone tree
    to_torch: Callable  # (backbone, cfg, encoder config.json or None) -> its state dict
    widths: Callable  # cfg -> (text feature width, image feature width)
    text: Callable  # (backbone, batch, cfg, generator) -> pooled text features
    image: Callable  # (backbone, embedded patch tokens, cfg) -> pooled image features


@dataclasses.dataclass(frozen=True)
class Backbone:
    """One model family: its config, its parameters in both layouts, the
    features each head reads, and the facts the engine, the trainer and
    the CLIs act on."""

    default: Callable[[], Any]  # the canonical architecture's config
    from_dict: Callable[[dict], Any]  # a local ``config.json`` -> config
    init: Callable  # (generator, cfg, dtype) -> the fusion model's backbone tree
    from_torch: Callable  # (state dict, cfg, prefix) -> that tree, from HF names under prefix
    to_torch: Callable  # (tree, cfg, prefix) -> its HF-named fp32 CPU state dict
    feature_dim: Callable  # cfg -> the width of both features the fusion head takes
    text: Callable  # (backbone, batch, cfg, generator) -> the fusion head's text features
    image: Callable  # (backbone, embedded patch tokens, cfg) -> its image features
    multitask: Optional[MultiTask]  # None: the multi-task head has no such backbone
    image_stats: Tuple[tuple, tuple]  # the default normalisation (mean, std)
    class_token: bool  # the vision tower prepends a class token to the patches
    exact_buckets: bool  # narrower text buckets leave the logits as they are
    bucket_extra: int  # columns a bucket keeps beside the longest row: 1 carry, 0 truncation
    count_packing: Optional[Callable] = None  # (cfg, host mask): the tower packs kept tokens
    dropout_fork: bool = False  # the towers' dropout draws from a fork of the head's generator
    training_refused: Optional[str] = None  # why the trainer refuses the family
    kernels: Tuple[str, ...] = ()  # kernels the family's forward adds to the common ones

    @property
    def text_fit_exact(self) -> bool:
        """Whether dropping trailing pad columns leaves the logits as they
        are, as a bucket without a carry column does (CLIP's causal tower
        pooled at the first EOS); SigLIP pools the last position, so its
        pads are not inert."""
        return self.exact_buckets and not self.bucket_extra

    def vision_positions(self, cfg) -> int:
        """The positions the vision tower runs: the patches and any class
        token."""
        v = cfg.vision
        return (v.image_size // v.patch_size) ** 2 + int(self.class_token)


def _clip_text(bp, batch, cfg, generator):
    return clip.clip_text_features(bp, batch["input_ids"], batch.get("attention_mask"), cfg)


def _clip_text_pooled(bp, batch, cfg, generator):
    return clip.clip_text_pooled(bp, batch["input_ids"], batch.get("attention_mask"), cfg.text)


def _clip_bare_init(g, cfg, dtype):
    backbone = clip.clip_init(g, cfg, dtype)
    for name in TOP_LEVEL:
        backbone.pop(name, None)
    return backbone


def _siglip_text(bp, batch, cfg, generator):
    return siglip.siglip_text_features(bp, batch["input_ids"], batch.get("attention_mask"), cfg,
                                       position_ids=batch.get("position_ids"))


def _generic_text(bp, batch, cfg, generator):
    return generic.generic_text_features(bp, batch["input_ids"], batch.get("attention_mask"),
                                         cfg, generator)


def _generic_text_pooled(bp, batch, cfg, generator):
    return generic.generic_text_pooled(bp, batch["input_ids"], batch.get("attention_mask"),
                                       cfg.text, generator)


def _deepseek_text(bp, batch, cfg, generator):
    return deepseek_v2.deepseek_text_features(
        bp, batch["input_ids"], batch.get("attention_mask"), cfg,
        kept=batch.get("text_kept"), counters=batch.get("counters"))


def _kimi_text(bp, batch, cfg, generator):
    return kimi_linear.kimi_text_features(
        bp, batch["input_ids"], batch.get("attention_mask"), cfg,
        kept=batch.get("text_kept"), counters=batch.get("counters"))


_CLIP = Backbone(
    default=clip.CLIPConfig.base_patch32,
    from_dict=clip.clip_config_from_dict,
    init=clip.clip_init,
    from_torch=clip.clip_params_from_torch,
    to_torch=clip.clip_to_torch,
    feature_dim=lambda c: c.projection_dim,
    text=_clip_text,
    image=clip.clip_image_features_from_tokens,
    multitask=MultiTask(
        backend="clip",
        init=_clip_bare_init,
        from_torch=clip.clip_towers_from_torch,
        to_torch=lambda bp, c, enc: clip.clip_to_torch(
            bp, c, text="tower_txt.text_model", vision="tower_img.vision_model"),
        widths=lambda c: (c.text.hidden_size, c.vision.hidden_size),
        text=_clip_text_pooled,
        image=lambda bp, x, c: clip.clip_vision_pooled_from_tokens(bp, x, c.vision),
    ),
    image_stats=(CLIP_MEAN, CLIP_STD),
    class_token=True,
    # a causal tower pooled at the first EOS never sees the dropped pads
    exact_buckets=True,
    bucket_extra=0,
)

_SIGLIP = Backbone(
    default=siglip.SigLIPConfig.base_patch16_224,
    from_dict=siglip.siglip_config_from_dict,
    init=siglip.siglip_init,
    from_torch=siglip.siglip_params_from_torch,
    to_torch=siglip.siglip_to_torch,
    # the text head's projection_size, which is the vision hidden size
    feature_dim=lambda c: c.text.projection_size,
    text=_siglip_text,
    image=siglip.siglip_image_features_from_tokens,
    multitask=MultiTask(
        backend="auto",
        init=siglip.siglip_init,
        from_torch=lambda sd, c: siglip.siglip_params_from_torch(sd, c, prefix="backbone."),
        to_torch=lambda bp, c, enc: siglip.siglip_to_torch(bp, c, "backbone."),
        widths=lambda c: (c.text.projection_size, c.vision.hidden_size),
        text=_siglip_text,
        image=siglip.siglip_image_features_from_tokens,
    ),
    image_stats=(SIGLIP_MEAN, SIGLIP_STD),
    class_token=False,
    # the tower pools the last column: a bucket carries a PAD there at the
    # full width's last position (``fast_infer.bucket_batch_text``)
    exact_buckets=True,
    bucket_extra=1,
)

_GENERIC = Backbone(
    default=generic.GenericDualConfig,
    from_dict=generic.GenericDualConfig.from_dict,
    init=generic.generic_init,
    from_torch=generic.generic_params_from_torch,
    to_torch=generic.generic_to_torch,
    # the reference's probe: projection_dim, else the text width, else the
    # vision width
    feature_dim=lambda c: c.projection_dim or c.text.hidden_size or c.vision.hidden_size,
    text=_generic_text,
    image=generic.generic_image_features_from_tokens,
    multitask=MultiTask(
        backend="generic",
        # the raw towers: no projections, no logit_scale
        init=lambda g, c, dtype: generic.generic_init(
            g, dataclasses.replace(c, projection_dim=0), dtype),
        from_torch=generic.generic_bare_from_torch,
        to_torch=generic.generic_bare_to_torch,
        widths=lambda c: (c.text.hidden_size, c.vision.hidden_size),
        text=_generic_text_pooled,
        image=lambda bp, x, c: generic.generic_vision_pooled_from_tokens(bp, x, c.vision),
    ),
    image_stats=(SIGLIP_MEAN, SIGLIP_STD),
    class_token=True,
    # a tower may mean-pool over every position, pads included: it runs at
    # the full width
    exact_buckets=False,
    bucket_extra=1,
    dropout_fork=True,
)

_DEEPSEEK_V2 = Backbone(
    default=deepseek_v2.DeepSeekV2Config.lite_siglip2_224,
    from_dict=deepseek_v2.DeepSeekV2Config.from_dict,
    init=deepseek_v2.deepseek_v2_init,
    from_torch=deepseek_v2.deepseek_v2_params_from_torch,
    to_torch=deepseek_v2.deepseek_v2_to_torch,
    # text_projection's width, which SigLIP's MAP feature has too
    feature_dim=lambda c: c.projection_dim,
    text=_deepseek_text,
    image=siglip.siglip_image_features_from_tokens,
    multitask=None,
    image_stats=(SIGLIP_MEAN, SIGLIP_STD),
    class_token=False,
    # a causal tower pooled at the last kept token never sees the dropped pads
    exact_buckets=True,
    bucket_extra=0,
    count_packing=deepseek_v2.count_packing,
    training_refused=("its 15.7 B parameters take about 250 GB with AdamW's state, more "
                      "than one card; it scores only"),
    kernels=("add_layer_norm", "moe"),  # its RMSNorms and its expert layer
)

_KIMI_LINEAR = Backbone(
    default=kimi_linear.KimiLinearConfig.published_siglip2_224,
    from_dict=kimi_linear.KimiLinearConfig.from_dict,
    init=kimi_linear.kimi_linear_init,
    from_torch=kimi_linear.kimi_linear_params_from_torch,
    to_torch=kimi_linear.kimi_linear_to_torch,
    feature_dim=lambda c: c.projection_dim,
    text=_kimi_text,
    image=siglip.siglip_image_features_from_tokens,
    multitask=None,
    image_stats=(SIGLIP_MEAN, SIGLIP_STD),
    class_token=False,
    # a causal tower (KDA's recurrence and causal MLA) pooled at the last
    # kept token never sees the dropped pads
    exact_buckets=True,
    bucket_extra=0,
    count_packing=kimi_linear.count_packing,
    training_refused=("its 48.7 B parameters take about 780 GB with AdamW's state, more "
                      "than one card; it scores only"),
    kernels=("add_layer_norm", "moe", "kda"),  # its RMSNorms, expert layer and KDA core
)

BACKBONES = {"clip": _CLIP, "siglip": _SIGLIP, "auto": _SIGLIP, "generic": _GENERIC,
             "deepseek_v2": _DEEPSEEK_V2, "kimi_linear": _KIMI_LINEAR}


def backbone(name: str) -> Backbone:
    """The family of a backend name (any case); another name raises."""
    record = BACKBONES.get(name.lower())
    if record is None:
        raise ValueError(f"backend {name.lower()!r}: want one of {', '.join(BACKBONES)}")
    return record


def multitask(name: str) -> MultiTask:
    """The multi-task towers of a backend name; a family without them
    raises."""
    towers = backbone(name).multitask
    if towers is None:
        raise NotImplementedError(f"the multi-task head has no {name.lower()} backbone: use "
                                  "the fusion head (head: fusion)")
    return towers
