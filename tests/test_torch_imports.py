"""The port stands alone: no file of it (or chip_smoke.py) imports JAX or
the JAX package, and the modules on the card's path import without pandas,
PIL, sklearn, yaml, regex or transformers (which the card machine lacks) and
without safetensors (which the port must not need: it reads the format
itself)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_content_moderation_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "multimodal_content_moderation_tpu")

# what chip_smoke.py drives on the card: the CLIP and SigLIP eval paths, the
# training path, the multi-task model, the moderation endpoint with the evaluate CLI (CSV rows,
# the CLIP BPE tokenizer, JPEG decode, the pixel cache), the int8 fc1 tier and the export
CARD_PATH_MODULES = [
    "multimodal_content_moderation_tpu_torch.utils.compile_cache",
    "multimodal_content_moderation_tpu_torch.data.tokenizer",
    "multimodal_content_moderation_tpu_torch.data.dataset",
    "multimodal_content_moderation_tpu_torch.data.native",
    "multimodal_content_moderation_tpu_torch.data.cache",
    "multimodal_content_moderation_tpu_torch.cli.common",
    "multimodal_content_moderation_tpu_torch.cli.evaluate",
    "multimodal_content_moderation_tpu_torch.cli.inference",
    "multimodal_content_moderation_tpu_torch.cli.export",
    "multimodal_content_moderation_tpu_torch.serving",
    "multimodal_content_moderation_tpu_torch.serving.handler",
    "multimodal_content_moderation_tpu_torch.serving.server",
    "multimodal_content_moderation_tpu_torch.testdata",
    "multimodal_content_moderation_tpu_torch.ops._build",
    "multimodal_content_moderation_tpu_torch.ops.cuda_image",
    "multimodal_content_moderation_tpu_torch.ops.cuda_attention",
    "multimodal_content_moderation_tpu_torch.ops.cuda_flash",
    "multimodal_content_moderation_tpu_torch.ops.layers",
    "multimodal_content_moderation_tpu_torch.ops.quant",
    "multimodal_content_moderation_tpu_torch.models.clip",
    "multimodal_content_moderation_tpu_torch.models.siglip",
    "multimodal_content_moderation_tpu_torch.models.generic",
    "multimodal_content_moderation_tpu_torch.models.fusion",
    "multimodal_content_moderation_tpu_torch.models.multitask",
    "multimodal_content_moderation_tpu_torch.models.u8wire",
    "multimodal_content_moderation_tpu_torch.models.bridge",
    "multimodal_content_moderation_tpu_torch.models.convert",
    "multimodal_content_moderation_tpu_torch.models.model_io",
    "multimodal_content_moderation_tpu_torch.models.export",
    "multimodal_content_moderation_tpu_torch.models.fast_infer",
    "multimodal_content_moderation_tpu_torch.data.pipeline",
    "multimodal_content_moderation_tpu_torch.data.images",
    "multimodal_content_moderation_tpu_torch.data.tokenizer_json",
    "multimodal_content_moderation_tpu_torch.ops.losses",
    "multimodal_content_moderation_tpu_torch.training.optim",
    "multimodal_content_moderation_tpu_torch.training.sampling",
    "multimodal_content_moderation_tpu_torch.training.checkpoints",
    "multimodal_content_moderation_tpu_torch.training.metrics",
    "multimodal_content_moderation_tpu_torch.training.loop",
    "multimodal_content_moderation_tpu_torch.utils.profiling",
    "chip_smoke",
]
# the packages the card's path must import without
MISSING_ON_CARD_MACHINE = [
    "jax", "jaxlib", "multimodal_content_moderation_tpu", "pandas", "PIL", "sklearn",
    "yaml", "safetensors", "regex", "transformers",
]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN_ROOTS, f"{path.name} imports {name}"


BLOCKER = """
import importlib.abc, sys
BLOCKED = set({blocked!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is blocked")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import importlib
for mod in {mods!r}:
    importlib.import_module(mod)
print("ok")
"""


def test_card_path_imports_without_missing_packages():
    code = BLOCKER.format(
        blocked=MISSING_ON_CARD_MACHINE, repo=str(REPO), mods=CARD_PATH_MODULES
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=str(REPO),
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
