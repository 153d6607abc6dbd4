"""A model family is a file: nothing in the harness, the reference or the
operation counts names a family or a backend, and the families' modules
import nothing of the measured port. The grouped draw: with one group it is
the single-buffer draw bit for bit (kept here as the oracle); with small
groups it repeats by seed, differs across seeds, scales each leaf as the
single draw does, frees each group's fp32 buffer before the next, and
keeps every leaf a view of one buffer of the target dtype."""

import ast
import json
import os
import weakref

import numpy as np
import pytest
import torch

from harness_util import ROOT, TINY
from benchmark.harness import spec, weights

BENCH = os.path.join(ROOT, "benchmark")
FAMILIES = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "families"))
                  if f.endswith(".py"))
NAMES = set(FAMILIES) | {"clip", "siglip", "generic", "auto"}  # with the port's backends


def _family_literals(source):
    """Each comparison with, and dict key of, a family or backend name."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Compare):
            for x in [node.left, *node.comparators]:
                items = x.elts if isinstance(x, (ast.Tuple, ast.List, ast.Set)) else [x]
                found += [i.value for i in items
                          if isinstance(i, ast.Constant) and i.value in NAMES]
        elif isinstance(node, ast.Dict):
            found += [k.value for k in node.keys if isinstance(k, ast.Constant)
                      and k.value in NAMES]
    return found


def _files(*tops):
    for top in tops:
        for d, _, fs in os.walk(os.path.join(BENCH, top)):
            yield from (os.path.join(d, f) for f in sorted(fs) if f.endswith(".py"))


def test_harness_names_no_family():
    # the scan finds what the harness held before the families' files
    assert _family_literals('extra = 0 if backend == "clip" else 1') == ["clip"]
    assert _family_literals('f = {"clip": a, "siglip": b}[cfg["family"]]') == ["clip", "siglip"]
    assert _family_literals('ok = cfg["family"] in ("clip", "siglip")') == ["clip", "siglip"]
    for path in _files("harness", "reference", "flops"):
        assert _family_literals(open(path, encoding="utf-8").read()) == [], path


@pytest.mark.parametrize("path", sorted(_files("families")), ids=os.path.basename)
def test_family_imports_nothing_of_the_port(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "multimodal_content_moderation_tpu_torch" not in names


def single_buffer_draw(cfg, seed, device, dtype):
    """The draw before groups: one normal draw for the whole model, scaled
    in place, then cast."""
    leaves = weights.spec(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in leaves]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, k = {}, 0
    with torch.no_grad():
        for (name, shape, kind, scale), n in zip(leaves, sizes):
            t = flat[k:k + n].view(shape)
            k += n
            if kind == "const":
                t.fill_(scale)
            else:
                t.mul_(scale)
                if kind == "ones":
                    t.add_(1.0)
            out[name] = t
        if dtype != torch.float32:
            flat = flat.to(dtype)
            k = 0
            for (name, shape, _, _), n in zip(leaves, sizes):
                out[name] = flat[k:k + n].view(shape)
                k += n
    return out


def _config(name):
    if name.startswith("tiny-"):
        return spec.load_cell(f"{name}.score", TINY).config
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))


@pytest.mark.parametrize("name,dtype", [("tiny-clip", torch.float32),
                                        ("tiny-clip", torch.bfloat16),
                                        ("tiny-siglip", torch.float32),
                                        ("tiny-siglip", torch.bfloat16),
                                        ("siglip2-b16-224-fusion", torch.bfloat16)])
def test_one_group_is_the_single_buffer_draw(name, dtype):
    cfg = _config(name)
    sizes = [int(np.prod(s)) for _, s, _, _ in weights.spec(cfg)]
    assert weights.groups(sizes) == [(0, len(sizes))]
    got = weights.draw(cfg, 3_000_000_061, torch.device("cpu"), dtype)
    want = single_buffer_draw(cfg, 3_000_000_061, torch.device("cpu"), dtype)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def _buffer(sd):
    ptrs = {t.untyped_storage().data_ptr() for t in sd.values()}
    assert len(ptrs) == 1
    return ptrs.pop()


def test_grouped_draw(monkeypatch):
    cfg = _config("tiny-siglip")
    leaves = weights.spec(cfg)
    sizes = [int(np.prod(s)) for _, s, _, _ in leaves]
    monkeypatch.setattr(weights, "CHUNK", 20_000)
    groups = weights.groups(sizes)
    assert len(groups) > 10
    assert [a for a, _ in groups[1:]] == [b for _, b in groups[:-1]]
    assert all(sum(sizes[a:b]) <= 20_000 or b == a + 1 for a, b in groups)
    assert max(sizes) > 20_000  # the embedding: a group of its own
    # each group's fp32 buffer is freed before the next is drawn
    live, randn = [], torch.randn

    def tracked(*a, **k):
        assert all(r() is None for r in live)
        t = randn(*a, **k)
        live.append(weakref.ref(t))
        return t

    monkeypatch.setattr(torch, "randn", tracked)
    cpu = torch.device("cpu")
    for dtype in (torch.float32, torch.bfloat16):
        a = weights.draw(cfg, 3_000_000_067, cpu, dtype)
        b = weights.draw(cfg, 3_000_000_067, cpu, dtype)
        c = weights.draw(cfg, 3_000_000_071, cpu, dtype)
        for sd in (a, c):
            _buffer(sd)
            assert all(t.dtype == dtype for t in sd.values())
        assert all(torch.equal(a[k], b[k]) for k in a)
        for name, shape, kind, scale in leaves:
            t = a[name].float()
            if kind == "const":
                assert (t == torch.tensor(scale).to(dtype).float()).all()
                continue
            assert not torch.equal(a[name], c[name])
            n = t.numel()
            if kind == "ones":
                assert abs(float(t.mean()) - 1.0) < 5 * scale / n ** 0.5
            elif n >= 64:
                assert abs(float(t.std()) / scale - 1.0) < 5 / (2 * n) ** 0.5 + 0.01
