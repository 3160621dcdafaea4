"""The port's counterparts of the JAX package's ``benchmarks/``.

The Pallas probes: each module builds its inputs from a seed, runs its CUDA
kernel at the JAX probe's full shape, holds it against its plain PyTorch
version and prints rates. Run one with

    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_vpu_ops
    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_lazy_probe
    python -m nested_hashing_psi_tpu_torch.benchmarks.bench_ntt_anatomy

(``--device cpu`` runs the plain version alone, at small sizes.) The
end-to-end bench with the offline artifact's save and resume
(``bench_e2e_psi``) and the offline build's profile by stage
(``profile_build``) run the same way, and ``probe_sweep`` times A2 and A3
of several trees of the port in turns.
"""
