"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` (top-level names compared whole: ``repro_torch``
is not ``repro``), and the reference loads nothing of ``repro_torch``."""
import ast
import json
import os
import subprocess
import sys
import types

import pytest

from bench import run
from bench.spec import BENCH, ROOT

ENV = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
           JAX_PLATFORMS="cpu")


def _modules():
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts:
            continue
        yield ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)


def _loaded_after(code: str) -> list:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"], env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_whole_name_comparison(monkeypatch):
    fake = {n: types.ModuleType(n) for n in (
        "repro_torch", "repro_torch.serving", "jaxtyping", "reprox",
        "flaxen", "bench.run")}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "repro",
                 "repro.serving"):
        fake[name] = types.ModuleType(name)
    assert run.forbidden_modules() == sorted(run.FORBIDDEN)


def test_every_module_and_a_whole_run_load_no_jax():
    mods = list(_modules())
    assert "bench.run" in mods and "bench.metrics.mfu" in mods
    code = "\n".join(f"import {m}" for m in mods) + """
import torch, sys
sys.path.insert(0, 'bench/tests')
from conftest import _tiny
from bench import run
cell, cfg = _tiny('phi3-mini.chat-sessions')
run.execute(cell, 3, 2.0, True, torch.device('cpu'), cfg=cfg,
            log=lambda s: None)
"""
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded
    assert not set(loaded) & set(run.FORBIDDEN), loaded


def test_reference_loads_nothing_of_the_program():
    """Every reference module (each family's, and what they share among
    themselves under ``bench.reference``) loads nothing of the port."""
    refs = [m for m in _modules() if m.startswith("bench.reference.")]
    assert "bench.reference.model" in refs
    loaded = _loaded_after("\n".join(f"import {m}" for m in refs))
    assert "repro_torch" not in loaded and "repro" not in loaded
    for p in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "contextlib",
                                           "__future__") \
                    or n.startswith("bench.reference."), (p, n)


def test_refuses_without_a_card():
    """No CUDA card here: exit 2 and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                        "qwen3-14b.long-docs-backlog", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout.strip() == ""
