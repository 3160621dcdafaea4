"""PyTorch + CUDA port of the nested-hashing PSI framework.

The JAX package ``nested_hashing_psi_tpu`` is the reference; this package
mirrors its layout (``config``, ``hashing``, ``data``, ``ops``, ``fhe``,
``pie``, ``protocol``, ``utils``, ``cli``) and imports ``torch``, never
``jax`` and nothing of the JAX package: the host-only modules it needs
(config, hashing, data, protocol base and channel, the native g++ helpers)
are its own copies. Residues are int32 tensors with the same bits as the
reference's uint32 ones. The hand-written CUDA kernels live in ``csrc/``
(the NTT, ``ops/ntt_cuda.py``; the PIE position sum,
``ops/pie_kernels.py``; the int8 tensor-core NTT, ``ops/ntt_mxu.py``) and
are built with nvcc at first use.
"""

__version__ = "0.1.0"
