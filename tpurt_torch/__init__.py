"""PyTorch/CUDA port of tpurt (pbrt-v3 with Random Parameter Filtering).

The JAX package ``tpurt`` is the reference; this package renders the same
``.pbrt`` scenes with the same integrators (path, volpath,
directlighting, whitted, ao, rpf, bdpt, mlt and sppm), samplers,
filters, cameras, materials, textures, shapes, lights and media, through
the same command line (``python -m tpurt_torch.cli``).  What is not
ported (the realistic camera, fourier and subsurface materials, ptex,
``Accelerator "kdtree"``, ``--spectrum sampled``) raises
``NotImplementedError`` naming the feature.

It imports torch and never jax, and nothing of tpurt: the host modules it
shares with tpurt are its own copies under the same names
(``tpurt_torch.scene``, ``geom``, ``render.geometry_build``,
``render.materials``, ``render.textures``, ``sampling.lowdiscrepancy``,
``sampling.rng``, ``spectrum``, ``io``, ``native``).  The device is always
explicit: pass ``device="cuda"`` or ``device="cpu"``.

Both of tpurt's Pallas kernels run as hand-written CUDA kernels on CUDA
tensors and as their plain PyTorch versions on CPU tensors
(``tpurt_torch.kernels``): BVH traversal (``csrc/traverse.cu``) and the
gather probe (``csrc/gather_bench.cu``).
"""
