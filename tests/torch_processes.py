"""Processes launched on their own, side by side: ``free_port`` and
``run_processes``, for ``tests/test_torch_multihost.py`` (its CPU cases
and its case on the card).

Imports neither JAX nor torch, and is not a test module.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time


def free_port() -> int:
    """A free TCP port on 127.0.0.1; take it just before the processes start."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(cmds: list, log_dir: str, timeout: float, cwd: str,
                  env: dict | None = None) -> tuple[list, list, bool]:
    """Start every command at once, each with its stdout and stderr in one
    file under ``log_dir``, and wait for all to a shared deadline ``timeout``
    seconds away. Past it every process still running is killed.
    -> (exit codes, outputs, timed_out)."""
    logs = [os.path.join(log_dir, f"proc{i}.log") for i in range(len(cmds))]
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, cwd=cwd, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline, timed_out = time.monotonic() + timeout, False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    return [p.returncode for p in procs], outs, timed_out
