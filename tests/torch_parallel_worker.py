"""One rank of the port's multi-device checks on the CPU
(tests/test_torch_parallel.py), run as its own process:

    python tests/torch_parallel_worker.py INIT_FILE RANK WORLD OUT_DIR

It joins a gloo group through ``file://INIT_FILE``, renders SCENE with
``render_sharded`` (film rows reduce-scattered, then all-reduced) and
``volpath_scene`` (reduce-scattered), filters
the seeded buffers of ``filter_buffer`` with ``rpf_filter_sharded`` (box 5
over ragged row blocks, and box 7, whose halo is wider than a block), and
rank 0 writes the results to OUT_DIR/results.npz.  It imports torch and
the port only.
"""

import sys
from pathlib import Path

import numpy as np

# tpurt's tests/test_parallel.py scene
SCENE = """
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Camera "perspective" "float fov" [60]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [10 10 10]
  Translate 0 3 4
  Shape "sphere" "float radius" [.5]
AttributeEnd
Material "matte" "color Kd" [.6 .5 .4]
Shape "trianglemesh" "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
  "integer indices" [0 1 2 2 3 0]
Translate 0 0 4
Shape "sphere" "float radius" [1]
WorldEnd
"""


def volpath_scene() -> str:
    """A volpath scene whose image tells tpurt's sharded render from its
    single-device one: a grid medium (4x5x6 seeded densities) in a
    ``Material "none"`` sphere, whose tracking hash numbers the lanes
    within each shard, before a wall under a checkerboard texture, which
    the sharded render shades from the material table's constants."""
    dens = np.random.default_rng(0).uniform(0, 1, (6, 5, 4))
    values = " ".join("%g" % v for v in dens.astype(np.float32).ravel())
    return f"""
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "random" "integer pixelsamples" [4]
Integrator "volpath" "integer maxdepth" [4]
MakeNamedMedium "smoke" "string type" "heterogeneous"
  "integer nx" [4] "integer ny" [5] "integer nz" [6]
  "float density" [{values}]
  "point p0" [-1 -1 2] "point p1" [1 1 4]
  "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [1.5 1.5 1.5]
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "color I" [10 10 10] "point from" [0 3 3]
AttributeBegin
  Material "none"
  MediumInterface "smoke" ""
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
Texture "checks" "spectrum" "checkerboard" "float uscale" [4]
  "float vscale" [4] "color tex1" [.9 .9 .9] "color tex2" [.1 .1 .1]
Material "matte" "texture Kd" "checks"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-3 -3 6  3 -3 6  3 3 6  -3 3 6]
WorldEnd
"""


# (rows, box) of the filter cases: 7 rows are ragged over 2 and 3 ranks;
# box 7's halo of 3 rows is wider than the 2-row blocks of 4 rows
FILTER_CASES = ((7, 5), (4, 7))


def filter_buffer(h: int, w: int = 6, s: int = 2, seed: int = 0,
                  offset: float = 1.0):
    """A well-conditioned (h, w, s, 19) sample buffer (tpurt's
    test_parallel.py recipe: features ``offset`` + 0.01 noise).  With the
    offset at 1 the filter's one-pass feature std keeps ~3 digits, enough
    where only the pixel's own samples weigh (sigma seed 0.002); a strong
    seed blends by the normalised features and wants offset 0."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((h, w, s, 19), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    buf[..., 0] = xx[..., None] + rng.uniform(0, 1, (h, w, s))
    buf[..., 1] = yy[..., None] + rng.uniform(0, 1, (h, w, s))
    buf[..., 2:5] = rng.uniform(0, 2, (h, w, s, 3))
    buf[..., 5:7] = rng.uniform(0, 1, (h, w, s, 2))
    buf[..., 7:19] = offset + 0.01 * rng.standard_normal((h, w, s, 12))
    return buf


def main(init_file: str, rank: int, world: int, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from tpurt_torch.parallel.mesh import (gather_rows, make_group,
                                           render_sharded,
                                           rpf_filter_sharded, shard_rows)
    from tpurt_torch.scene import load_scene_string

    group = make_group("cpu", init_method=f"file://{init_file}", rank=rank,
                       world_size=world)
    out = {}
    for scatter in (True, False):
        img, _ = render_sharded(load_scene_string(SCENE), group,
                                scatter_film=scatter, device="cpu")
        out[f"render_scatter_{int(scatter)}"] = img
    out["volpath"], _ = render_sharded(load_scene_string(volpath_scene()),
                                       group, device="cpu")
    for h, box in FILTER_CASES:
        block = shard_rows(torch.tensor(filter_buffer(h)), group)
        got = rpf_filter_sharded(block, box, h, group)
        out[f"filter_{h}_{box}"] = gather_rows(got, h, group).numpy()
    if rank == 0:
        np.savez(Path(out_dir) / "results.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
