"""PyTorch/CUDA port of tpurt's path-render slice.

The JAX package ``tpurt`` is the reference; this package renders the same
``.pbrt`` scenes with ``Integrator "path"`` (RGB), the Halton sampler
(affine scramble), a perspective camera, a box filter, matte and plastic
materials, triangle meshes, spheres, sphere/triangle area lights and
point lights.  Anything else raises ``NotImplementedError`` naming the
feature.

It imports torch and never jax: the host halves it shares with tpurt come
from tpurt's jax-free modules only (``tpurt.scene``, ``tpurt.geom.wbvh``,
``tpurt.render.geometry_build``, ``tpurt.io``,
``tpurt.sampling.lowdiscrepancy``).  The device is always explicit: pass
``device="cuda"`` or ``device="cpu"``.

BVH traversal runs through a hand-written CUDA kernel
(``tpurt_torch/csrc/traverse.cu``) on CUDA tensors and through its plain
PyTorch twin on CPU tensors (``tpurt_torch.kernels.traverse``).
"""
