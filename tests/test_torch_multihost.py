"""Independently launched processes joined over TCP: the port's counterpart of
``tests/test_multihost.py``.

- Two worker processes (``tests/torch_multihost_worker.py``) join at
  ``tcp://127.0.0.1:<free port>`` through gloo; each runs the batched-PIE
  online step on the global (dp 2 x tp 1) mesh and holds the gathered
  result bit-exact against its own unsharded ``batched_pie_forward``;
  process 0 decrypts it to [105, 131].
- The port's ``scaling_report`` in its multi-process mode, two processes
  on the CPU: at dp 2 x tp 1, at dp 1 x tp 2 (tp crossing the processes)
  and on the JAX tool's own command line (``--cpu --coordinator
  host:port --num-processes 2 --process-id i``); and (marker ``gpu``) both
  on one card at ring 16384, each launching K1 and K2. Process 0 alone
  prints the report, with row (c) bit-equal; processes whose inputs differ
  both fail at the digest check.
- Its flags: ``--ranks`` with ``--num-processes 2``, and ``--num-processes
  2`` without ``--coordinator``, are errors; an nccl process that shares
  its card with another raises and does not fall back to gloo.

Each port is taken just before the processes start, as
``tests/test_multihost.py`` does; a hard timeout kills both processes and
reports both outputs.
"""

import json
import os
import socket
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

import torch_processes
from nested_hashing_psi_tpu_torch.benchmarks import scaling_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120.0  # s, for both processes together
TOOL = [sys.executable, "-m", "nested_hashing_psi_tpu_torch.benchmarks.scaling_report"]
SMALL = ["--ring", "64", "--limbs", "4", "--depths", "4", "--positions", "4", "--iters", "2"]


def run_processes(cmds: list, tmp_path) -> list:
    """Run the commands side by side: [(exit code, output)]. Past TIMEOUT
    both are killed and the test fails with both outputs."""
    codes, outs, timed_out = torch_processes.run_processes(
        cmds, str(tmp_path), TIMEOUT, REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))
    if timed_out:
        pytest.fail(f"no end within {TIMEOUT:.0f} s:\n" + "\n".join(
            f"--- process {i}:\n{out[-3000:]}" for i, out in enumerate(outs)))
    return list(zip(codes, outs))


def _report(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out[-3000:]
    return json.loads(lines[0])


def test_two_process_sharded_pie(tmp_path):
    worker = os.path.join(REPO, "tests", "torch_multihost_worker.py")
    coord = f"tcp://127.0.0.1:{torch_processes.free_port()}"
    res = run_processes([[sys.executable, worker, coord, "2", str(i)] for i in range(2)],
                        tmp_path)
    for i, (rc, out) in enumerate(res):
        assert rc == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK proc={i}" in out


@pytest.mark.parametrize("argv,label", [
    pytest.param(["--device", "cpu", *SMALL, "--tp", "1"], "2 processes, dp 2 x tp 1, gloo",
                 id="dp2_tp1"),
    pytest.param(["--device", "cpu", *SMALL, "--tp", "2"], "2 processes, dp 1 x tp 2, gloo",
                 id="dp1_tp2"),
    pytest.param(["--cpu"], "2 processes, dp 2 x tp 1, gloo",  # the JAX tool's command line
                 id="jax_command_line"),
    # both processes on one card at ring 16384, L = 8, D = 16 (NCCL refuses
    # two ranks on one card: gloo, staged through host memory)
    pytest.param(["--device", "cuda", "--backend", "gloo", "--ring", "16384", "--limbs", "8",
                  "--depths", "16", "--tp", "1"], "2 processes, dp 2 x tp 1, gloo",
                 id="card_ring16384", marks=pytest.mark.gpu),
])
def test_scaling_report_across_processes(tmp_path, argv, label):
    device = "cuda" if "cuda" in argv else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port = torch_processes.free_port()
    coord = f"127.0.0.1:{port}" if "--cpu" in argv else f"tcp://127.0.0.1:{port}"
    res = run_processes([TOOL + argv + ["--coordinator", coord, "--num-processes", "2",
                                        "--process-id", str(i)] for i in range(2)], tmp_path)
    for i, (rc, out) in enumerate(res):
        assert rc == 0, f"process {i} failed:\n{out[-4000:]}"
    assert not [line for line in res[1][1].splitlines() if line.startswith("{")]
    rep = _report(res[0][1])
    rows = rep["rows"]
    assert [r["label"] for r in rows] == ["1 device, unsharded", label]
    assert [r["ranks"] for r in rows] == [1, 2]
    staged = " staged through host memory" if device == "cuda" else ""
    assert rows[1]["bit_equal"] is True and rows[1]["transport"] == "gloo" + staged
    assert len(rows[1]["launches"]) == 2 and rows[1]["efficiency"] > 0
    assert rep["device"] == device
    if device == "cuda":  # each process launched K1 both ways and K2 over its queries
        assert all(min(c.values()) > 0 for c in rows[1]["launches"]), rows[1]["launches"]


def test_processes_with_different_inputs_both_fail(tmp_path):
    coord = f"tcp://127.0.0.1:{torch_processes.free_port()}"
    res = run_processes([TOOL + ["--device", "cpu", *SMALL[:4], "--depths", str(d),
                                 "--coordinator", coord, "--num-processes", "2",
                                 "--process-id", str(i)] for i, d in enumerate((4, 2))],
                        tmp_path)
    for i, (rc, out) in enumerate(res):
        assert rc != 0 and "the processes built different host inputs" in out, out[-3000:]


@pytest.mark.parametrize("argv,match", [
    (["--ranks", "2", "--num-processes", "2", "--coordinator", "tcp://127.0.0.1:1"],
     "cannot be combined"),
    (["--num-processes", "2"], "needs --coordinator"),
    (["--num-processes", "2", "--process-id", "2", "--coordinator", "tcp://127.0.0.1:1"],
     "not in"),
])
def test_flag_combinations_that_are_errors(capsys, argv, match):
    with pytest.raises(SystemExit):
        scaling_report.parse_args(["--cpu", *argv])
    assert match in capsys.readouterr().err


def test_tp_defaults_and_cpu_flag():
    assert scaling_report.parse_args([]).tp == 2
    a = scaling_report.parse_args(["--cpu", "--num-processes", "2", "--coordinator", "h:1"])
    assert (a.tp, a.device, a.iters) == (1, "cpu", None)


@pytest.mark.parametrize("backend", [["--backend", "nccl"], []], ids=["nccl", "default"])
def test_nccl_processes_sharing_a_card_raise(tmp_path, monkeypatch, backend):
    """On the card the backend defaults to nccl, and a second nccl process on
    the one card raises the one-rank-per-device error: it never falls back
    to gloo. (Process 0's post to the store is written beforehand.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(uuid="GPU-A"))
    path = str(tmp_path / "store")
    dist.FileStore(path, 2).set("nhpsi/nccl_device/0", f"{socket.gethostname()}/GPU-A")
    with pytest.raises(ValueError, match="nccl needs one GPU per rank"):
        scaling_report.main(["--device", "cuda", *backend, "--coordinator", f"file://{path}",
                             "--num-processes", "2", "--process-id", "1"])
    assert not dist.is_initialized()
