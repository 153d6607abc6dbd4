"""Package setup for multimodal_content_moderation_tpu."""

from setuptools import find_packages, setup

setup(
    name="multimodal-content-moderation-tpu",
    version="0.1.0",
    description=(
        "TPU-native multi-modal (image + text) content-moderation framework: "
        "CLIP/SigLIP dual encoders with gated-fusion and multi-task heads in "
        "JAX/XLA/Pallas, trained and served over device meshes"
    ),
    packages=find_packages(include=["multimodal_content_moderation_tpu*"],
                           exclude=["multimodal_content_moderation_tpu_torch*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pandas",
        "pyyaml",
        "pillow",
        "optax",
        "orbax-checkpoint",
        "scikit-learn",
        "regex",
        "safetensors",
    ],
    extras_require={
        "dev": ["pytest>=7.0.0", "torch", "transformers"],
        "serving": ["tokenizers"],
    },
    entry_points={
        "console_scripts": [
            "mmharm-train=multimodal_content_moderation_tpu.cli.train:main",
            "mmharm-evaluate=multimodal_content_moderation_tpu.cli.evaluate:main",
            "mmharm-infer=multimodal_content_moderation_tpu.cli.inference:main",
            "mmharm-prepare-data=multimodal_content_moderation_tpu.cli.prepare_data:main",
            "mmharm-deploy=multimodal_content_moderation_tpu.serving.deploy:main",
            "mmharm-serve=multimodal_content_moderation_tpu.serving.server:main",
            "mmharm-export=multimodal_content_moderation_tpu.cli.export:main",
        ]
    },
)
