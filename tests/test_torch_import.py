"""tpurt_torch stands alone: it imports neither JAX nor the JAX package.

With ``sys.modules["jax"] = None`` and ``sys.modules["tpurt"] = None``
(any ``import jax...`` or ``import tpurt...`` then raises) the package
imports and renders a 16x16, 1 spp path scene and a 16x16, 2 spp RPF
scene on the CPU; that runs in a subprocess so this test process's own
imports do not leak in.  An AST scan of every module of the package and
of chip_smoke.py finds no import of either, function-local ones included.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import sys
sys.modules["jax"] = None
sys.modules["tpurt"] = None
import numpy as np
import tpurt_torch
from tpurt_torch.render.driver import load_scene, render
from tpurt_torch.rpf.driver import render_rpf
from tpurt_torch.testscenes import write_standin

path = write_standin(sys.argv[1], "small")
sd = load_scene(path)
sd.film_params.add("integer", "xresolution", [16])
sd.film_params.add("integer", "yresolution", [16])
sd.sampler_params.add("integer", "pixelsamples", [1])
img, job = render(sd, device="cpu")
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0

sd = load_scene(write_standin(sys.argv[2], "small", integrator="rpf"))
sd.film_params.add("integer", "xresolution", [16])
sd.film_params.add("integer", "yresolution", [16])
rimg, rjob, _ = render_rpf(sd, device="cpu")
assert rimg.shape == (16, 16, 3) and np.isfinite(rimg).all()
assert rimg.mean() > 0 and rjob.sampler.spp == 2
loaded = [m for m, v in sys.modules.items()
          if v is not None and (m in ("jax", "tpurt")
                                or m.startswith(("jax.", "jaxlib", "tpurt.")))]
assert not loaded, loaded
print("OK", job.sampler.spp, float(img.mean()))
'''


def test_tpurt_torch_imports_and_renders_without_jax(tmp_path):
    # one torch thread, as in the port's other tests
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "s.pbrt"),
         str(tmp_path / "r.pbrt")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK 1 ")
    assert len(list(tmp_path.glob("r_*.exr"))) == 6  # the feature EXRs


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_module_of_the_port_imports_jax_or_tpurt():
    files = sorted((ROOT / "tpurt_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [f"{f.relative_to(ROOT)}:{line} imports {root}"
           for f in files
           for root, line in _imported_roots(ast.parse(f.read_text()))
           if root in ("jax", "jaxlib", "tpurt")]
    assert not bad, bad
