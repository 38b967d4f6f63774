"""PyTorch/CUDA port of tpurt (pbrt-v3 with Random Parameter Filtering).

The JAX package ``tpurt`` is the reference; this package renders the same
``.pbrt`` scenes with the same integrators (path, volpath,
directlighting, whitted, ao, rpf, bdpt, mlt and sppm), samplers,
filters, cameras (the realistic camera's lens system included),
materials (fourier's tabulated BSDFs and the subsurface materials'
tabulated BSSRDF included), textures (Ptex included), shapes, lights and
media, in RGB or sampled spectra, under the wide BVH or the kd-tree,
through the same command line (``python -m tpurt_torch.cli``), on one
device or sharded over several (``tpurt_torch.parallel.mesh`` over
``torch.distributed``).  A feature tpurt does not have raises
``NotImplementedError`` naming it; a lens, .ptx or .bsdf file that is
missing or unreadable raises ``ValueError`` naming the feature and the
file.

It imports torch and never jax, and nothing of tpurt: the host modules it
shares with tpurt are its own copies under the same names
(``tpurt_torch.scene``, ``geom``, ``render.geometry_build``,
``render.materials``, ``render.textures``, ``render.lenses``,
``render.fourier``, ``sampling.lowdiscrepancy``, ``sampling.rng``,
``sampling.interpolation``, ``spectrum``, ``io`` with ``io.ptex``,
``native``).  The device is always
explicit: pass ``device="cuda"`` or ``device="cpu"``.

Both of tpurt's Pallas kernels run as hand-written CUDA kernels on CUDA
tensors and as their plain PyTorch versions on CPU tensors
(``tpurt_torch.kernels``): BVH traversal (``csrc/traverse.cu``) and the
gather probe (``csrc/gather_bench.cu``).
"""
