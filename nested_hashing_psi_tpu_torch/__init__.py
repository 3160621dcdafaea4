"""PyTorch + CUDA port of the nested-hashing PSI framework.

The JAX package ``nested_hashing_psi_tpu`` is the reference; this package
mirrors its layout (``ops``, ``fhe``, ``pie``, ``protocol``, ``cli``) and
imports ``torch``, never ``jax``. Residues are int32 tensors with the same
bits as the reference's uint32 ones. The two hand-written CUDA kernels live
in ``csrc/`` (the NTT, ``ops/ntt_cuda.py``; the PIE position sum,
``ops/pie_kernels.py``) and are built with nvcc at first use. Host-only
helpers that are already jax-free (config, hashing, data, protocol base and
channel, the native g++ helpers) are imported from the reference package.
"""

__version__ = "0.1.0"
