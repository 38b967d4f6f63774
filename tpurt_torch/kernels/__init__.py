"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- build.py: the one builder: nvcc (sm_90a) into build/tpurt_torch/, one
  library per source, loaded with ctypes; launch errors raise.
- traverse.py: wide-BVH traversal (closest-hit and any-hit), the port of
  tpurt's Pallas kernel ``tpurt/kernels/traverse.py:_kernel``; CUDA C++
  in ``tpurt_torch/csrc/traverse.cu``.
- gather_bench.py: the gather probe (sum of many dynamic 512-byte table
  rows), the port of ``tpurt/kernels/gather_bench.py:kernel``; CUDA C++
  in ``tpurt_torch/csrc/gather_bench.cu``.
"""
