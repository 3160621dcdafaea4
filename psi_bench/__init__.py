"""The benchmark of the PyTorch and CUDA port (``nested_hashing_psi_tpu_torch``).

``python -m psi_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See
``psi_bench/README.md``.
"""
