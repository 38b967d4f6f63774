"""portbench: the benchmark of tpurt_torch, the PyTorch/CUDA port of
tpurt (pbrt-v3 with Random Parameter Filtering), on NVIDIA H100 cards.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (README.md)."""
