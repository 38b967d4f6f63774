"""Nothing under portbench/ imports jax, jaxlib, flax or tpurt (top-level
names compared whole: tpurt_torch begins with tpurt), the plain reference
imports nothing of tpurt_torch, and a run without a CUDA card exits
non-zero and prints no result."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.tests.cells import ROOT

PKG = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "tpurt"}


def _top_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("part", ["harness", "reference"])
def test_no_jax_and_a_plain_reference(part):
    files = sorted(PKG.rglob("*.py"))
    ref = [f for f in files if "reference" in f.parts
           or f.name in ("compare.py", "scene.py")]
    assert ref and len(files) > len(ref)
    for f in (files if part == "harness" else ref):
        tops = _top_imports(f)
        assert not tops & JAX, (f, tops & JAX)
        if part == "reference":
            assert "tpurt_torch" not in tops, f
            assert not any(m.startswith("portbench.")
                           and not m.startswith("portbench.reference")
                           for m in _imports(f)), f


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "killeroo-rpf.halton8", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr
