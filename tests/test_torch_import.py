"""tpurt_torch needs no JAX: with ``sys.modules["jax"] = None`` (any
``import jax`` then raises) the package imports and renders a 16x16,
1 spp scene on the CPU.  Runs in a subprocess so this test process's own
jax import does not leak in."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import sys
sys.modules["jax"] = None
import numpy as np
import tpurt_torch
from tpurt_torch.render.driver import load_scene, render
from tpurt_torch.testscenes import write_standin

path = write_standin(sys.argv[1], "small")
sd = load_scene(path)
sd.film_params.add("integer", "xresolution", [16])
sd.film_params.add("integer", "yresolution", [16])
sd.sampler_params.add("integer", "pixelsamples", [1])
img, job = render(sd, device="cpu")
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0
loaded = [m for m, v in sys.modules.items()
          if v is not None and (m == "jax" or m.startswith(("jax.", "jaxlib")))]
assert not loaded, loaded
print("OK", job.sampler.spp, float(img.mean()))
'''


def test_tpurt_torch_imports_and_renders_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "s.pbrt")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK 1 ")
