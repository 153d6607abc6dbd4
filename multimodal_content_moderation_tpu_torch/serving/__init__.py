from multimodal_content_moderation_tpu_torch.serving.handler import (  # noqa: F401
    BatchTransformHandler,
    input_fn,
    model_fn,
    output_fn,
    predict_fn,
)
