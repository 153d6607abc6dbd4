"""The port's one table of model families (``models/backbones.py``): each
record's facts pinned as literals, the lookup's refusal, and two source
scans: no other port file (nor ``chip_smoke.py`` or ``bench_torch.py``)
compares a model-family name, and the imports among ``models/`` form no
cycle, with no function-level import of a ``models`` module to hide one."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

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
from multimodal_content_moderation_tpu_torch.models.backbones import (
    BACKBONES,
    backbone,
    multitask,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_content_moderation_tpu_torch"
MODELS = "multimodal_content_moderation_tpu_torch.models"

# name: (config type, exact buckets, bucket extra, packs, class token,
# image stats, multi-task backend, training refused, dropout fork, kernels)
FACTS = {
    "clip": (clip.CLIPConfig, True, 0, False, True, (CLIP_MEAN, CLIP_STD), "clip", False,
             False, ()),
    "siglip": (siglip.SigLIPConfig, True, 1, False, False, (SIGLIP_MEAN, SIGLIP_STD), "auto",
               False, False, ()),
    "auto": (siglip.SigLIPConfig, True, 1, False, False, (SIGLIP_MEAN, SIGLIP_STD), "auto",
             False, False, ()),
    "generic": (generic.GenericDualConfig, False, 1, False, True, (SIGLIP_MEAN, SIGLIP_STD),
                "generic", False, True, ()),
    "deepseek_v2": (deepseek_v2.DeepSeekV2Config, True, 0, True, False,
                    (SIGLIP_MEAN, SIGLIP_STD), None, True, False, ("add_layer_norm", "moe")),
    "kimi_linear": (kimi_linear.KimiLinearConfig, True, 0, True, False,
                    (SIGLIP_MEAN, SIGLIP_STD), None, True, False,
                    ("add_layer_norm", "moe", "kda")),
}


@pytest.mark.parametrize("name", sorted(FACTS))
def test_record_facts(name):
    (config, exact, extra, packs, class_token, stats, mtl, refused, fork,
     kernels) = FACTS[name]
    b = backbone(name)
    assert b is backbone(name.upper())
    assert type(b.default()) is config
    assert b.exact_buckets is exact and b.bucket_extra == extra
    assert (b.count_packing is not None) is packs
    assert b.class_token is class_token and b.image_stats == stats
    assert (b.multitask and b.multitask.backend) == mtl
    assert bool(b.training_refused) is refused
    assert b.dropout_fork is fork and b.kernels == kernels
    assert b.text_fit_exact is (exact and not extra)
    cfg = b.default()
    patches = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    assert b.vision_positions(cfg) == patches + class_token
    if mtl is None:
        with pytest.raises(NotImplementedError, match=f"no {name} backbone"):
            multitask(name)
    else:
        assert multitask(name) is b.multitask


def test_table_holds_the_five_names_and_refuses_others():
    assert list(BACKBONES) == ["clip", "siglip", "auto", "generic", "deepseek_v2",
                               "kimi_linear"]
    assert backbone("auto") is backbone("siglip")
    with pytest.raises(ValueError, match="'deepseek_v3': want one of clip, siglip, auto"):
        backbone("deepseek_v3")


def test_import_adds_no_work():
    """Importing the table opens no file besides its modules' sources,
    starts no card and builds or loads no kernel."""
    code = ("import builtins, io, torch\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError(f'opened {a[:1]}')\n"
            "builtins.open = io.open = refuse\n"
            "from multimodal_content_moderation_tpu_torch.models import backbones\n"
            "from multimodal_content_moderation_tpu_torch.ops import _build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not _build._libs and not _build.ptxas_reports\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# source scans
# ---------------------------------------------------------------------------

FAMILY_NAMES = set(BACKBONES) - {"auto"}  # "auto" is also a value of other options
# other notions named "backend": the image decoder, the process group's
OTHER_BACKENDS = {"pil", "native", "native_scaled", "nccl", "gloo"}
# the one parser of outside input allowed to read a family's name
ALLOWED_FUNCTIONS = {("models/model_io.py", "resolve_backend")}


def _strings(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return set().union(*(_strings(e) for e in node.elts)) if node.elts else set()
    return set()


def _names_a_backend(node) -> bool:
    return any((isinstance(n, ast.Name) and "backend" in n.id.lower())
               or (isinstance(n, ast.Attribute) and "backend" in n.attr.lower())
               or (isinstance(n, ast.Constant) and n.value == "backend")
               for n in ast.walk(node))


def family_comparisons(path: Path, rel: str):
    """The comparisons in ``path`` of a family name, or of a value named
    ``backend`` with strings: ``x == "clip"``, ``backend in ("clip", ...)``,
    ``model.backend != "auto"``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and (rel, node.name) in ALLOWED_FUNCTIONS:
            skip |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare) or id(node) in skip:
            continue
        operands = [node.left] + node.comparators
        strings = set().union(*(_strings(o) for o in operands))
        named = any(_names_a_backend(o) for o in operands if not _strings(o))
        if strings & FAMILY_NAMES or (named and strings - OTHER_BACKENDS):
            yield f"{rel}:{node.lineno}: {ast.unparse(node)}"


SCANNED = sorted(p for p in PORT.rglob("*.py") if p.name != "backbones.py") + [
    REPO / "chip_smoke.py", REPO / "bench_torch.py"]


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(REPO)))
def test_no_family_name_compared_outside_the_table(path):
    rel = str(path.relative_to(PORT if PORT in path.parents else REPO))
    assert list(family_comparisons(path, rel)) == []


def test_scan_finds_a_family_comparison(tmp_path):
    """The scan sees the forms a dispatch on the name takes."""
    src = tmp_path / "m.py"
    src.write_text("def f(model, backend, cfg):\n"
                   "    a = model.backend == 'clip'\n"
                   "    b = backend in ('generic', 'deepseek_v2')\n"
                   "    c = cfg['backend'] != 'auto'\n"
                   "    d = model.image_backend == 'pil'\n"
                   "    return 'siglip' if a else b\n")
    found = list(family_comparisons(src, "m.py"))
    assert [line.split(":")[1] for line in found] == ["2", "3", "4"]


def _models_imports(path: Path):
    """(module-level imports, function-level imports) of ``models`` modules
    in one file of ``models/``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top, nested = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        targets = []
        if isinstance(node, ast.Import):
            targets = [a.name for a in node.names]
        elif node.module == MODELS:
            targets = [f"{MODELS}.{a.name}" for a in node.names]
        elif node.module and node.module.startswith(MODELS + "."):
            targets = [node.module]
        mods = {t.split(".")[2] for t in targets if t.startswith(MODELS + ".")}
        (top if node.col_offset == 0 else nested).update(mods)
    return top, nested


def test_models_imports_form_no_cycle():
    graph, nested = {}, {}
    for path in sorted((PORT / "models").glob("*.py")):
        graph[path.stem], nested[path.stem] = _models_imports(path)
    assert {k: v for k, v in nested.items() if v} == {}
    state = {}

    def visit(mod, trail):
        if state.get(mod) == "done":
            return
        assert state.get(mod) != "open", f"import cycle: {' -> '.join(trail + [mod])}"
        state[mod] = "open"
        for dep in sorted(graph.get(mod, ())):
            visit(dep, trail + [mod])
        state[mod] = "done"

    for mod in graph:
        visit(mod, [])
    assert "backbones" in graph["fusion"] and "backbones" in graph["fast_infer"]
