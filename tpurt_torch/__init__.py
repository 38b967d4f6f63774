"""PyTorch/CUDA port of tpurt's path-render and RPF slices.

The JAX package ``tpurt`` is the reference; this package renders the same
``.pbrt`` scenes with ``Integrator "path"`` (RGB) or ``Integrator "rpf"``
(the path sampling pass with feature capture, the Random Parameter Filter
and the splat), the Halton sampler (affine scramble), a perspective
camera, a box filter, matte and plastic materials, triangle meshes,
spheres, sphere/triangle area lights and point lights.  Anything else
raises ``NotImplementedError`` naming the feature.

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
