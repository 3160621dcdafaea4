"""Start a group of rank processes, run one function in each, collect results.

``run_ranks(fn, world, backend, args)`` spawns ``world`` processes
(``multiprocessing`` spawn context: a fresh interpreter each, so a rank
never inherits the parent's CUDA state or threads). Each joins one process
group through a ``file://`` store in a new temporary directory (no TCP
port to race for when several launchers share a host), takes one torch
thread, runs ``fn(rank, world, *args)`` and sends back what it returns
(numpy arrays and plain Python values: it is pickled). If any rank raises,
exits without a result or outlives ``timeout``, every rank is killed and
``run_ranks`` raises with the ranks' tracebacks.

The ranks build nothing: a caller on a GPU builds the kernel library
(``ops.cuda_lib.get_lib()``) before it spawns them, and each rank loads
the built file. ``fn`` must be importable by its module path.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

from nested_hashing_psi_tpu_torch.parallel.multihost import init_distributed


def _rank_main(fn, rank: int, world: int, backend: str, store: str, args: tuple,
               results) -> None:
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)  # ranks share the host's cores
        init_distributed(f"file://{store}", world, rank, backend)
        try:
            out = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn, world: int, backend: str, args: tuple = (), timeout: float = 300.0) -> list:
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own rank process of one ``backend`` process group."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="nhpsi_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(fn, r, world, backend, os.path.join(tmp, "store"), args,
                               results))
             for r in range(world)]
    out, errors = {}, {}
    deadline = time.monotonic() + timeout

    def take(block: bool) -> None:
        rank, ok, val = results.get(timeout=1.0) if block else results.get_nowait()
        (out if ok else errors)[rank] = val

    try:
        for p in procs:
            p.start()
        while len(out) < world and not errors:
            try:
                take(block=True)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    try:  # a failed rank's traceback may still be in the queue
                        while True:
                            take(block=False)
                    except queue.Empty:
                        pass
                    errors.update({r: f"exited with code {procs[r].exitcode}"
                                   for r in dead if r not in errors})
                elif time.monotonic() > deadline:
                    errors["timeout"] = (f"{world - len(out)} of {world} ranks gave no "
                                         f"result within {timeout:.0f} s")
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if len(out) < world and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(f"rank processes failed ({backend}, world {world}):\n" + "\n".join(
            f"--- {k}:\n{v}" for k, v in errors.items()))
    return [out[r] for r in range(world)]
