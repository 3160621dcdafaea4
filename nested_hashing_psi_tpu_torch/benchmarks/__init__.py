"""The port's counterparts of the JAX package's Pallas probes under
``benchmarks/``: each module builds its inputs from a seed, runs its CUDA
kernel at the JAX probe's full shape, holds it against its plain PyTorch
version and prints rates. Run one with

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_vpu_ops
    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_lazy_probe
    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_anatomy

(``--device cpu`` runs the plain version alone, at small sizes.)
"""
