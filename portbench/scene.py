"""The benchmark's scene generator: a cell's ``.pbrt`` text from its
configuration, its traffic mix and ``--seed``.

The configuration names a template under ``portbench/scenes/`` (the
published scene file word for word, with its resolution, sampler and
integrator lines and each ``Include`` of a mesh the repo does not hold
left as fields) and the seeded stand-in of that mesh; the traffic mix
gives the ``Sampler`` directive.  The seed moves the stand-in's vertices
and nothing else: every directive, the bounds and the triangle count
stay, so every seed asks the same work of the renderer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def blob_mesh(n: int, seed: int):
    """Closed displaced-sphere mesh: n longitudes x (n+1) latitude rings
    plus two poles, 2*n*(n+1) triangles, unit-ish size, resting on y=0.
    Returns (vertices (V,3) f64, indices (T,3) i64).  Any whole ``seed``
    (negative or past 64 bits too) picks the displacement."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    rings = n + 1
    theta = np.pi * (np.arange(rings) + 1) / (rings + 1)
    phi = 2 * np.pi * np.arange(n) / n
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    dirs = np.concatenate([dirs, [[0, 1, 0], [0, -1, 0]]])
    freq = rng.normal(size=(6, 3)) * 2.5
    amp = rng.uniform(0.03, 0.09, 6)
    phase = rng.uniform(0, 2 * np.pi, 6)
    r = 1.0 + np.sin(dirs @ freq.T + phase) @ amp
    v = dirs * r[:, None] * np.array([1.0, 1.3, 1.0])
    i, j = np.meshgrid(np.arange(rings - 1), np.arange(n), indexing="ij")
    a, b = i * n + j, i * n + (j + 1) % n
    c, d = a + n, b + n
    quads = np.stack([np.stack([a, c, b], -1), np.stack([b, c, d], -1)],
                     2).reshape(-1, 3)
    top, bot = rings * n, rings * n + 1
    j = np.arange(n)
    caps = np.stack([np.stack([np.full(n, top), j, (j + 1) % n], -1),
                     np.stack([np.full(n, bot),
                               (rings - 1) * n + (j + 1) % n,
                               (rings - 1) * n + j], -1)], 1).reshape(-1, 3)
    v[:, 1] -= v[:, 1].min()
    return v, np.concatenate([quads, caps]).astype(np.int64)


def standin_mesh(spec: dict, seed: int):
    """The seeded blob fitted to ``spec["bounds"]`` ([lo xyz, hi xyz], the
    replaced mesh's object space, z up): the blob's up axis (y) becomes
    z by a cyclic permutation of the axes, which keeps the winding, and
    each axis is scaled onto the box.  Vertices rounded to the 5
    decimals the scene text carries."""
    v, idx = blob_mesh(spec["n"], seed)
    v = v[:, [2, 0, 1]]  # (x, y, z) <- (z, x, y): a rotation
    lo, hi = (np.asarray(b, np.float64) for b in spec["bounds"])
    vmin, vmax = v.min(0), v.max(0)
    v = lo + (v - vmin) / (vmax - vmin) * (hi - lo)
    return np.round(v, 5), idx


def mesh_text(v, idx) -> str:
    pts = " ".join(f"{x:.5f}" for x in v.reshape(-1))
    ids = " ".join(str(i) for i in idx.reshape(-1))
    return (f'Shape "trianglemesh"\n  "point P" [{pts}]\n'
            f'  "integer indices" [{ids}]\n')


def directive(kind: str, name: str, params: dict) -> str:
    """``kind "name" "type param" [values] ...`` from a {"type param":
    [values]} dict."""
    out = f'{kind} "{name}"'
    for key, vals in params.items():
        vals = vals if isinstance(vals, list) else [vals]
        out += f' "{key}" [{" ".join(str(x) for x in vals)}]'
    return out


def scene_text(config: dict, traffic: dict, seed: int,
               filename: str = "portbench.exr") -> str:
    """The cell's scene: ``config["scene"]`` (template, res, integrator,
    integrator_params, standin {field, n, bounds}) under
    ``traffic["sampler"]`` / ``traffic["sampler_params"]``."""
    sc = config["scene"]
    st = sc["standin"]
    v, idx = standin_mesh(st, seed)
    template = (HERE / "scenes" / sc["template"]).read_text()
    return template.format(**{
        "sampler": directive("Sampler", traffic["sampler"],
                             traffic["sampler_params"]),
        "integrator": directive("Integrator", sc["integrator"],
                                sc["integrator_params"]),
        "res": sc["res"], "filename": filename,
        st["field"]: mesh_text(v, idx)})


def write_scene(path, config: dict, traffic: dict, seed: int) -> str:
    """Write the cell's scene to ``path`` (its film names a file beside
    it, which no entry writes); returns ``path`` as a string."""
    path = Path(path)
    path.write_text(scene_text(config, traffic, seed,
                               str(path.with_suffix(".exr"))))
    return str(path)
