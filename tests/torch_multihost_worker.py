"""One process of ``tests/test_torch_multihost.py``: the port's counterpart of
``tests/multihost_worker.py``.

Joins a process group of ``num_procs`` independently launched processes at
``coordinator`` (``tcp://host:port``; process 0 serves the store) through
gloo, builds the small PIE on the CPU (every process the same, from the
same seeds), runs the batched-PIE online step on the global (dp
num_procs x tp 1) mesh, dp crossing the processes, and holds the gathered
result bit-exact against its own unsharded ``batched_pie_forward``.
Process 0 also decrypts it to the intersection [105, 131]. Imports no JAX.

    python tests/torch_multihost_worker.py <coordinator> <num_procs> <proc_id>
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nested_hashing_psi_tpu_torch.benchmarks.small_pie import build_small_pie  # noqa: E402
from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext  # noqa: E402
from nested_hashing_psi_tpu_torch.parallel import multihost  # noqa: E402
from nested_hashing_psi_tpu_torch.parallel.mesh import sharded_pie_step  # noqa: E402
from nested_hashing_psi_tpu_torch.pie.batched_fhe import batched_pie_forward  # noqa: E402


def main():
    coordinator, num_procs, proc_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    multihost.init_distributed(coordinator, num_procs, proc_id, "gloo")
    try:
        assert dist.get_world_size() == num_procs and dist.get_rank() == proc_id
        ctx, sk, rlk, pie, ops, idx_ct, minus_ct = build_small_pie(
            ring=256, limbs=8, H=2, P=8, D=8, simple=32, device="cpu")
        truth = batched_pie_forward(ctx, rlk, idx_ct.data, minus_ct.data, pie.table_pt,
                                    pie.mask_pt)
        mesh = multihost.global_mesh(dp=num_procs, tp=1, device="cpu")
        fn, specs = sharded_pie_step(ctx, mesh)
        g = multihost.host_to_global
        out = fn(g(mesh, specs["idx"], idx_ct.data.numpy()),
                 g(mesh, specs["minus"], minus_ct.data.numpy()),
                 g(mesh, specs["table"], pie.table_pt.numpy()),
                 g(mesh, specs["mask"], pie.mask_pt.numpy()),
                 g(mesh, specs["rlk"], rlk.b_mont.numpy()),
                 g(mesh, specs["rlk"], rlk.a_mont.numpy()))
        got = multihost.global_to_host(out, mesh, specs["out"])
        if not np.array_equal(got, truth.data.numpy().view(np.uint32)):
            raise AssertionError("the multi-process sharded PIE differs from the unsharded step")
        if proc_id == 0:
            ct = Ciphertext(torch.from_numpy(got.view(np.int32)), form=truth.form)
            slots, _ = ctx.decrypt(ct, sk, length=pie.batch_slots)
            vals = sorted(int(lo) for lo, _ in ops.extract_intersection(np.asarray(slots)))
            if vals != [105, 131]:
                raise AssertionError(f"process 0 decrypts to {vals}, not [105, 131]")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"MULTIHOST_OK proc={proc_id}", flush=True)


if __name__ == "__main__":
    main()
