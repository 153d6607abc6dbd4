"""Package setup for multimodal_content_moderation_tpu_torch, the PyTorch/CUDA
port (``setup.py`` packages the JAX package beside it; the two share no
file).

    pip install .                      # the JAX package (setup.py)
    python setup_torch.py bdist_wheel  # the port

The port needs torch and numpy only; the CUDA sources ship with it, and its
kernels are built with nvcc at first use on the card.
"""

from setuptools import find_packages, setup

setup(
    name="multimodal-content-moderation-tpu-torch",
    version="0.1.0",
    description=(
        "PyTorch/CUDA port of the multi-modal (image + text) content-moderation "
        "framework: CLIP/SigLIP/generic dual encoders with gated-fusion and "
        "multi-task heads, hand-written Hopper kernels, training and serving "
        "on one NVIDIA GPU"
    ),
    packages=find_packages(include=["multimodal_content_moderation_tpu_torch*"]),
    package_data={
        "multimodal_content_moderation_tpu_torch": [
            "csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp", "testdata/jpeg/*",
        ],
    },
    python_requires=">=3.10",
    install_requires=["torch", "numpy"],
    extras_require={
        # faster or optional paths; the port runs without every one of them
        "yaml": ["pyyaml"],
        "images": ["pillow"],
        "safetensors": ["safetensors"],
        "aws": ["boto3", "sagemaker"],
        "dev": ["pytest>=7.0.0", "hypothesis", "pyyaml", "pillow", "pandas", "regex",
                "safetensors", "transformers"],
    },
    entry_points={
        "console_scripts": [
            "mmharm-torch-train=multimodal_content_moderation_tpu_torch.cli.train:main",
            "mmharm-torch-evaluate=multimodal_content_moderation_tpu_torch.cli.evaluate:main",
            "mmharm-torch-infer=multimodal_content_moderation_tpu_torch.cli.inference:main",
            "mmharm-torch-export=multimodal_content_moderation_tpu_torch.cli.export:main",
            "mmharm-torch-prepare-data="
            "multimodal_content_moderation_tpu_torch.cli.prepare_data:main",
            "mmharm-torch-deploy=multimodal_content_moderation_tpu_torch.serving.deploy:main",
            "mmharm-torch-serve=multimodal_content_moderation_tpu_torch.serving.server:main",
        ]
    },
)
