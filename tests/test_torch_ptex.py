"""Ptex against tpurt on the CPU (tpurt_torch/io/ptex.py, the "ptex"
branch of render/texeval.py, the face index of render/interaction.py):
the container read and written across both packages, the per-face
lookup against tpurt's _ptex_sample (1e-6), the face index of triangle
hits, and the raise for a missing or unreadable .ptx file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.io import ptex as tptex
from tpurt_torch.io import ptex as pptex
from tpurt_torch.testscenes import ptex_faces

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_ptex_container_round_trips_across_packages(tmp_path):
    """Float faces (one constant-encoded 1x1) written by each package read
    back bit-equal by the other; u8 faces normalize to [0, 1]; a file that
    is not Ptex raises PtexError."""
    rng = np.random.default_rng(0)
    faces = [rng.uniform(0, 1, (4, 8, 3)).astype(np.float32),
             rng.uniform(0, 1, (16, 2, 3)).astype(np.float32),
             rng.uniform(0, 1, (1, 1, 3)).astype(np.float32)]
    for writer, reader in ((pptex, tptex), (tptex, pptex)):
        p = str(tmp_path / f"{writer.__name__.split('.')[0]}.ptx")
        writer.write_ptex(p, faces)
        got = reader.read_ptex(p)
        assert got.nfaces == 3 and got.meshtype == pptex.MESH_QUAD
        for a, b in zip(faces, got.faces):
            np.testing.assert_array_equal(a, b)
    u8 = [np.arange(16, dtype=np.uint8).reshape(4, 4, 1) * 16]
    p = str(tmp_path / "u8.ptx")
    pptex.write_ptex(p, u8, datatype=np.uint8)
    np.testing.assert_array_equal(pptex.read_ptex(p).faces[0],
                                  tptex.read_ptex(p).faces[0])
    np.testing.assert_allclose(pptex.read_ptex(p).faces[0], u8[0] / 255.0,
                               atol=1e-7)
    bad = tmp_path / "bad.ptx"
    bad.write_bytes(b"NotAPtexFile" + b"\0" * 64)
    with pytest.raises(pptex.PtexError):
        pptex.read_ptex(str(bad))


def test_ptex_lookup_matches_tpurt(tmp_path):
    """The bilinear per-face lookup with clamped face-local uv, gamma 2.2
    and 1, on 4,096 seeded lanes (face ids out of range included), and a
    one-channel file replicated to grey."""
    from tpurt.render.texeval import _ptex_sample as t_sample

    from tpurt_torch.render.texeval import _ptex_sample, load_ptex

    rng = np.random.default_rng(1)
    n = 4096
    fi = rng.integers(-1, 18, n).astype(np.int32)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    gray = [f[..., :1] for f in ptex_faces(4)]
    for name, faces in (("rgb", ptex_faces()), ("gray", gray)):
        p = str(tmp_path / f"{name}.ptx")
        pptex.write_ptex(p, faces)
        tab = tuple(torch.tensor(a) for a in load_ptex(p))
        for gamma in (2.2, 1.0):
            want = np.asarray(t_sample(p, gamma, jnp.asarray(fi),
                                       jnp.asarray(u), jnp.asarray(v)))
            got = _ptex_sample(tab, gamma, torch.tensor(fi),
                               torch.tensor(u), torch.tensor(v)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            assert got.std() > 0.05


def test_face_index_of_hits_and_missing_file_raises(tmp_path):
    """On the tiny Ptex scene each ground hit reads the face its quad was
    given through "integer faceIndices" (both triangles of a quad the same
    face), the mesh (no faceIndices) reads 0, and the interaction carries
    no face index unless asked; a missing or unreadable .ptx raises
    ValueError naming Texture "ptex" and the file (tpurt renders 0.5
    grey)."""
    from torch_lens_fourier_scenes import ptex_fourier_tiny, write_inputs

    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.driver import build_job
    from tpurt_torch.render.interaction import compute_interaction
    from tpurt_torch.render.intersect import intersect_closest
    from tpurt_torch.scene import load_scene_string

    files = write_inputs(tmp_path)
    text = ptex_fourier_tiny(files)
    job = build_job(load_scene_string(text), "cpu")
    assert job.scene.has_ptex
    rng = np.random.default_rng(2)
    n = 2048
    o = torch.tensor(np.stack([rng.uniform(-5.5, 5.5, n), np.full(n, 2.0),
                               rng.uniform(-5.5, 5.5, n)], -1),
                     dtype=torch.float32)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3).contiguous()
    hit = intersect_closest(job.scene.geo, o, d, float("inf"), traverse_wide)
    si = compute_interaction(job.scene.geo, hit, o, d, faces=True)
    assert compute_interaction(job.scene.geo, hit, o, d).face_index is None
    ground = si.valid & (si.p[:, 1].abs() < 1e-4)
    quad = ((si.p[:, 0] > 0).long() + 2 * (si.p[:, 2] > 0).long())
    assert ground.float().mean() > 0.5
    assert torch.equal(si.face_index[ground].long(), quad[ground])
    mesh = si.valid & ~ground
    assert mesh.any() and (si.face_index[mesh] == 0).all()
    assert (si.face_index[~si.valid] == 0).all()
    missing = str(tmp_path / "missing.ptx")
    for path in (missing, files["bsdf"]):  # absent; not a Ptex file
        with pytest.raises(ValueError, match=f'Texture "ptex".*{path}'):
            build_job(load_scene_string(text.replace(files["ptx"], path)),
                      "cpu")
