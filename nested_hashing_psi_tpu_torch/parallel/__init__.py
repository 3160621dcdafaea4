"""Sharding of the PIE online steps over ranks of torch.distributed process
groups: dp over bin depths x tp over RNS limbs, the ring-sharded (sp),
pipelined (pp) and SimpleFHE steps, the two distributed NTTs, and the
multi-process mesh and launcher (counterpart of
``nested_hashing_psi_tpu.parallel``)."""
