"""The port's entry points against the JAX package's, on the CPU: the
NHPSI_RING_DIM / NHPSI_NUM_LIMBS overrides give the same PSIParams through
both command lines, ``python -m nested_hashing_psi_tpu_torch`` runs a
verifying client/server pair over localhost TCP, and ``run_in_process``
takes a data factory and a forced protocol, finding the JAX runner's
intersection on the same data."""

import dataclasses
import os
import socket
import subprocess
import sys

import pytest
import torch

from nested_hashing_psi_tpu import cli as j_cli
from nested_hashing_psi_tpu.config import HashTableParams as JHT
from nested_hashing_psi_tpu.config import PSIParams as JPSI
from nested_hashing_psi_tpu.data.input import FixedDataInput as JFixed
from nested_hashing_psi_tpu.protocol.runner import run_in_process as j_run
from nested_hashing_psi_tpu_torch import cli as t_cli
from nested_hashing_psi_tpu_torch.config import HashTableParams as THT
from nested_hashing_psi_tpu_torch.config import PSIParams as TPSI
from nested_hashing_psi_tpu_torch.data.input import FixedDataInput as TFixed
from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process as t_run

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-F", "--batched", "-B", "16", "-S", "300", "-C", "12", "-I", "5",
         "-e", "32", "-E", "12", "-k", "2", "-K", "2", "-b", "4"]
ENVS = {"both": {"NHPSI_RING_DIM": "128", "NHPSI_NUM_LIMBS": "8"},
        "ring_only": {"NHPSI_RING_DIM": "512"},
        "limbs_only": {"NHPSI_NUM_LIMBS": "7"},
        "neither": {}}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_env_overrides_give_the_jax_cli_params(monkeypatch, env):
    """The same argv and environment through both CLIs' main (their TCP
    runners replaced by a recorder) and the port's parse_args."""
    for k in ("NHPSI_RING_DIM", "NHPSI_NUM_LIMBS"):
        monkeypatch.delenv(k, raising=False)
    base = dataclasses.asdict(t_cli.parse_args(FLAGS)[0])
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    got = {}

    def recorder(name):
        def run(psi, ht, **kw):
            got[name] = (dataclasses.asdict(psi), dataclasses.asdict(ht))
            return None, True
        return run

    monkeypatch.setattr(j_cli, "run_client_tcp", recorder("jax"))
    monkeypatch.setattr(t_cli, "run_client_tcp", recorder("port"))
    assert j_cli.main(["client", *FLAGS]) == 0
    assert t_cli.main(["client", *FLAGS, "--device", "cpu"]) == 0
    assert got["port"] == got["jax"]
    psi, ht, device = t_cli.parse_args(FLAGS)
    assert (dataclasses.asdict(psi), dataclasses.asdict(ht)) == got["jax"]
    assert device == "cuda"
    for field, var in (("ring_dim", "NHPSI_RING_DIM"), ("num_limbs", "NHPSI_NUM_LIMBS")):
        want = int(ENVS[env][var]) if var in ENVS[env] else base[field]
        assert got["port"][0][field] == want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_dash_m_pair_over_tcp():
    """`python -m nested_hashing_psi_tpu_torch server|client` on the CPU, at
    ring 128 from the environment, verifies over localhost TCP."""
    env = dict(os.environ, NHPSI_RING_DIM="128", NHPSI_NUM_LIMBS="8")
    flags = FLAGS + ["--port", str(_free_port()), "--device", "cpu"]
    cmd = [sys.executable, "-m", "nested_hashing_psi_tpu_torch"]
    server = subprocess.Popen(cmd + ["server"] + flags, cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        client = subprocess.run(cmd + ["client"] + flags, cwd=REPO, env=env,
                                capture_output=True, text=True, timeout=600)
        assert client.returncode == 0, client.stdout + client.stderr
        assert "Set matches!" in client.stdout
        assert server.wait(timeout=60) == 0
    finally:
        if server.poll() is None:
            server.kill()
    usage = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert usage.returncode == 2 and "usage" in usage.stderr


SMALL = dict(server_set_size=300, client_set_size=12, intersection_set_size=5,
             hash_seed=987654321, item_seed=123456789, bit_size=16, fhe=True,
             batched=True, ring_dim=128, num_limbs=8)
SMALL_HT = dict(each_simple_table_size=32, each_cuckoo_table_size=12,
                n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                max_items_per_position=4)


# the ElGamal runs' small geometry (tests/test_elgamal.py's)
ELGAMAL = dict(server_set_size=60, client_set_size=4, intersection_set_size=2,
               curve_name="P-192")
ELGAMAL_HT = dict(SMALL_HT, each_simple_table_size=8, each_cuckoo_table_size=6,
                  max_items_per_position=3)


@pytest.fixture
def jax_pure_python_ec(monkeypatch):
    """JAX ElGamal parties use the pure-Python group law (no in-place build
    of the JAX package's native library)."""
    from nested_hashing_psi_tpu.utils import native_ec, native_ec2m

    monkeypatch.setattr(native_ec, "for_curve", lambda *a, **k: None)
    monkeypatch.setattr(native_ec2m, "for_curve", lambda *a, **k: None)


@pytest.mark.parametrize("flags_say,forced", [("BatchedFHE", "BatchedFHE"),
                                              ("SimpleElGamal", "BatchedFHE"),
                                              ("BatchedFHE", "PrecompElGamal")],
                         ids=["BatchedFHE", "SimpleElGamal", "forced_PrecompElGamal"])
def test_run_in_process_data_factory_and_protocol(capsys, jax_pure_python_ec, flags_say,
                                                  forced):
    """A FixedDataInput set through both runners with the protocol forced to
    BatchedFHE (the flags choose it too, or choose SimpleElGamal) or to
    PrecompElGamal (the flags choose BatchedFHE): both verify and find the
    same intersection, the fixed set's."""
    psi = dict(SMALL, fhe=flags_say == "BatchedFHE")
    ht = SMALL_HT
    if forced == "PrecompElGamal":
        psi, ht = dict(psi, **ELGAMAL), ELGAMAL_HT
    sizes = (psi["server_set_size"], psi["client_set_size"], psi["intersection_set_size"], 16)
    t_client, _, t_ok = t_run(TPSI(**psi), THT(**ht), data_factory=lambda: TFixed(*sizes),
                              protocol=forced, device="cpu")
    j_client, _, j_ok = j_run(JPSI(**psi), JHT(**ht), data_factory=lambda: JFixed(*sizes),
                              protocol=forced)
    assert t_ok and j_ok
    assert capsys.readouterr().out.count("Set matches!") == 2
    found = sorted(map(tuple, t_client.intersection_calculated))
    assert found == sorted(map(tuple, j_client.intersection_calculated))
    assert found == sorted(map(tuple, TFixed(*sizes).get_intersection_set().tolist()))


def test_run_in_process_forced_elgamal_raises(capsys):
    """A forced PrecompElGamal runs to a verified result (the flags choose
    BatchedFHE); an unknown protocol name raises."""
    client, _, ok = t_run(TPSI(**dict(SMALL, **ELGAMAL)), THT(**ELGAMAL_HT),
                          protocol="PrecompElGamal", device="cpu")
    assert ok and client.protocol_name == "PrecompP-192"
    assert "Set matches!" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown protocol"):
        t_run(TPSI(**SMALL), THT(**SMALL_HT), protocol="NoSuchPSI", device="cpu")
