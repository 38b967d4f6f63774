"""Hand-written Hopper kernels, each beside its plain PyTorch twin.

- traverse.py: wide-BVH traversal (closest-hit and any-hit), the port of
  tpurt's Pallas kernel ``tpurt/kernels/traverse.py:_kernel``; CUDA C++
  in ``tpurt_torch/csrc/traverse.cu``.
"""
