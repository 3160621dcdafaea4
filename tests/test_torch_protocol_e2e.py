"""End-to-end BatchedFHE protocol of the port, alone and mixed with the JAX
package: the self-verifying client must print "Set matches!".

The mixed runs put a JAX party and a port party on the two ends of a
serializing loopback channel (every frame crosses as wire bytes), in both
directions, with the client verifying against the generator's ground truth.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu.data.input import RandomDataInput
from nested_hashing_psi_tpu.protocol import batched_fhe as j_proto
from nested_hashing_psi_tpu.protocol import simple_fhe as j_simple
from nested_hashing_psi_tpu.protocol.channel import LoopbackChannel
from nested_hashing_psi_tpu_torch import cli
from nested_hashing_psi_tpu_torch.fhe.bgv import BGVContext
from nested_hashing_psi_tpu_torch.protocol import batched_fhe as t_proto
from nested_hashing_psi_tpu_torch.protocol import simple_fhe as t_simple
from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_params(**over):
    base = dict(
        server_set_size=300, client_set_size=12, intersection_set_size=5,
        hash_seed=987654321, item_seed=123456789, bit_size=16, fhe=True,
        batched=True, ring_dim=128, num_limbs=8,
    )
    base.update(over)
    return PSIParams(**base)


def small_ht(**over):
    base = dict(
        each_simple_table_size=32, each_cuckoo_table_size=12,
        n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
        max_items_per_position=4,
    )
    base.update(over)
    return HashTableParams(**base)


@pytest.mark.parametrize("queries", [1, 2])
@pytest.mark.parametrize("bits", [16, 32])
def test_port_run_in_process(capsys, queries, bits):
    psi = small_params(num_queries=queries, bit_size=bits, num_limbs=8 if bits == 16 else 10)
    client, server, ok = run_in_process(psi, small_ht(), device="cpu")
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 5
    assert server.pie.mul_limbs < server.ctx.L
    assert set(client.measurements) == {"Setup", "Offline", "Online"}
    assert client.measurements["Online"].bytes_out > 0


def test_port_run_in_process_empty_intersection():
    client, _, ok = run_in_process(
        small_params(intersection_set_size=0, client_set_size=8), small_ht(),
        device="cpu",
    )
    assert ok and len(client.intersection_calculated) == 0


def test_port_run_in_process_one_cuckoo_hash():
    """H = 1: no cross-hash product, the masked position sum ships as is."""
    client, server, ok = run_in_process(
        small_params(), small_ht(n_cuckoo_hash_functions=1, max_items_per_position=8),
        device="cpu",
    )
    assert ok and len(client.intersection_calculated) == 5
    assert server.pie.mul_limbs is None


def test_port_run_in_process_full_client_in_server():
    client, _, ok = run_in_process(small_params(client_set_size=6, intersection_set_size=6),
                                   small_ht(), device="cpu")
    assert ok and len(client.intersection_calculated) == 6


def test_port_run_in_process_three_cuckoo_hfs():
    client, _, ok = run_in_process(small_params(num_limbs=12),
                                   small_ht(n_cuckoo_hash_functions=3), device="cpu")
    assert ok and len(client.intersection_calculated) == 5


def test_server_rejects_invalid_chunk_count():
    """The port's server validates the chunk count it reads off the wire: a
    non-divisor of the inner position count fails the session with a clear
    error (tests/test_protocol_e2e.py's check, on the port)."""
    from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel as TLoopback

    peer, ours = TLoopback.pair()
    peer.write_tensor(np.zeros((2, 2, 4), np.uint32))  # minus ciphertext
    peer.write_tensor(np.array([7], np.uint64))  # 7 does not divide P = 12
    srv = t_proto.BatchedFHEPSIServer.__new__(t_proto.BatchedFHEPSIServer)
    srv.channel = ours
    srv.ht = small_ht()
    srv.device = torch.device("cpu")  # each frame is uploaded as it is received
    with pytest.raises(ValueError, match="chunk count 7"):
        srv.run_online_phase()


def simple_params(**over):
    """tests/test_simple_fhe.py's SimpleFHE geometry."""
    return small_params(**{**dict(batched=False, ring_dim=64, server_set_size=200,
                                  client_set_size=8, intersection_set_size=4), **over})


def simple_ht(**over):
    return small_ht(**{**dict(each_simple_table_size=16, each_cuckoo_table_size=10,
                              max_items_per_position=6), **over})


def test_simple_fhe_e2e_empty():
    client, _, ok = run_in_process(simple_params(intersection_set_size=0, client_set_size=5),
                                   simple_ht(), device="cpu")
    assert ok and len(client.intersection_calculated) == 0


def test_simple_fhe_bin_size_equals_table_size():
    """The reference's FHEHIPPIE geometry (binSize == tableSize)."""
    _, _, ok = run_in_process(simple_params(),
                              simple_ht(each_cuckoo_table_size=8, max_items_per_position=8),
                              device="cpu")
    assert ok


def test_simple_fhe_bgv_default_limbs():
    """--bgv with the default limb budget: it models the EvalSum ladder's
    key-switch noise for BGV too, with 20 bits to spare."""
    client, server, ok = run_in_process(simple_params(bgv=True, num_limbs=0), simple_ht(),
                                        device="cpu")
    assert ok and len(client.intersection_calculated) == 4
    assert client.noise_bits < server.ctx.params.num_limbs * 31 - 20


def _mixed(client_cls, server_cls, psi, ht, client_kw, server_kw):
    """One client/server pair over a serializing loopback channel."""
    def data():
        return RandomDataInput(psi.server_set_size, psi.client_set_size,
                               psi.intersection_set_size, psi.item_seed, psi.bit_size)

    ch_c, ch_s = LoopbackChannel.pair(pass_device_arrays=False)
    client = client_cls(data(), psi, ht, ch_c, **client_kw)
    server = server_cls(data(), psi, ht, ch_s, **server_kw)
    errors = []

    def serve():
        try:
            server.run()
        except BaseException as e:  # surface in the main thread
            errors.append(e)
            ch_s.poison()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        ok = client.run()
    finally:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    return client, server, ok


@pytest.mark.parametrize("chunks", [2, 4])
def test_port_run_in_process_streamed(capsys, chunks):
    """--streamChunks: the index ciphertexts cross in chunks that the server
    position-sums as they arrive; the result verifies."""
    psi = small_params(stream_chunks=chunks, bit_size=32, num_limbs=10)
    client, server, ok = run_in_process(psi, small_ht(), device="cpu")
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 5
    assert client._effective_chunks() == chunks
    assert not server.pie.host_table


def test_port_server_takes_host_table_above_threshold(monkeypatch, capsys):
    """A packed table above HOST_TABLE_BYTES stays in host memory and the
    run still verifies (the threshold lowered so a small table crosses it)."""
    monkeypatch.setattr(t_proto, "HOST_TABLE_BYTES", 1024)
    client, server, ok = run_in_process(
        small_params(bit_size=32, num_limbs=10, stream_chunks=3), small_ht(), device="cpu"
    )
    assert ok and "Set matches!" in capsys.readouterr().out
    assert server.pie.host_table and server.pie.table_pt.device.type == "cpu"
    assert len(client.intersection_calculated) == 5


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_mixed_jax_and_port_streamed(capsys, direction):
    """--streamChunks 4 across packages: the chunk frames are the same."""
    psi, ht = small_params(stream_chunks=4, bit_size=32, num_limbs=10), small_ht()
    cpu = {"device": "cpu"}
    if direction == "jax_client_port_server":
        pair = (j_proto.BatchedFHEPSIClient, t_proto.BatchedFHEPSIServer, {}, cpu)
    else:
        pair = (t_proto.BatchedFHEPSIClient, j_proto.BatchedFHEPSIServer, cpu, {})
    client, _, ok = _mixed(*pair[:2], psi, ht, *pair[2:])
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 5


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
@pytest.mark.parametrize("queries", [1, 2])
def test_mixed_jax_and_port(capsys, direction, queries):
    psi, ht = small_params(num_queries=queries, bit_size=32, num_limbs=10), small_ht()
    cpu = {"device": "cpu"}
    if direction == "jax_client_port_server":
        pair = (j_proto.BatchedFHEPSIClient, t_proto.BatchedFHEPSIServer, {}, cpu)
    else:
        pair = (t_proto.BatchedFHEPSIClient, j_proto.BatchedFHEPSIServer, cpu, {})
    client, _, ok = _mixed(*pair[:2], psi, ht, *pair[2:])
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 5


# --bgv on the batched protocol: leveled at 16-bit items (Q = 1, Q = 2 and
# a streamed upload), flat at 32-bit; SimpleFHE (-F without --batched)
# under BFV and BGV. The limb counts come from the packages' own rules.
BGV_AND_SIMPLE = {
    "bgv16_leveled": dict(bgv=True),
    "bgv16_leveled_q2": dict(bgv=True, num_queries=2),
    "bgv16_leveled_stream2": dict(bgv=True, stream_chunks=2),
    "bgv32_flat": dict(bgv=True, bit_size=32),
    "simple_bfv": dict(batched=False),
    "simple_bgv": dict(batched=False, bgv=True),
}
SIMPLE_FHE_SIZES = dict(ring_dim=64, server_set_size=200, client_set_size=8,
                        intersection_set_size=4)


def _case(name):
    psi = small_params(num_limbs=None, **BGV_AND_SIMPLE[name])
    if psi.batched:
        return psi, small_ht()
    return (dataclasses.replace(psi, **SIMPLE_FHE_SIZES),
            small_ht(each_simple_table_size=16, each_cuckoo_table_size=10,
                     max_items_per_position=6))


@pytest.mark.parametrize("case", sorted(BGV_AND_SIMPLE))
def test_port_bgv_and_simple_fhe_run_in_process(capsys, case):
    psi, ht = _case(case)
    client, server, ok = run_in_process(psi, ht, device="cpu")
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == psi.intersection_set_size
    assert server.ctx.default_form == ("bgv" if psi.bgv else "bfv")
    if psi.batched:
        # leveled exactly at 16-bit items: the result ships L - (H-1) limbs
        assert server.pie.leveled == (psi.bit_size == 16)
        shipped = server.ctx.L - (1 if server.pie.leveled else 0)
        assert client.noise_bits < 31 * shipped - 10


DECRYPT_CASES = {("BatchedFHE", "bfv"): None, ("BatchedFHE", "bgv"): "bgv32_flat",
                 ("SimpleFHE", "bfv"): "simple_bfv", ("SimpleFHE", "bgv"): "simple_bgv"}


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
@pytest.mark.parametrize("protocol", ["BatchedFHE", "SimpleFHE"])
def test_clients_decrypt_only_through_result_zero_mask(monkeypatch, protocol, scheme):
    """Both FHE clients pick their decrypt in one place: the host decrypt
    runs only inside ``protocol.batched_fhe.result_zero_mask``, which each
    client looks up at call time (the benchmark harness replaces it), and
    the intersection is the one the client finds without the spy."""
    name = DECRYPT_CASES[(protocol, scheme)]
    psi, ht = (small_params(bit_size=32, num_limbs=10), small_ht()) if name is None \
        else _case(name)
    client, _, ok = run_in_process(psi, ht, device="cpu")
    assert ok and len(client.intersection_calculated) == psi.intersection_set_size
    want = sorted(map(tuple, client.intersection_calculated))

    real, host_decrypt = t_proto.result_zero_mask, BGVContext.decrypt
    calls, inside, outside = [], [], []

    def spy(ctx, result, sk, length, decryptors):
        calls.append(result.form)
        inside.append(True)
        try:
            return real(ctx, result, sk, length, decryptors)
        finally:
            inside.pop()

    def watched(self, *args, **kw):
        if not inside:
            outside.append(args)
        return host_decrypt(self, *args, **kw)

    monkeypatch.setattr(t_proto, "result_zero_mask", spy)
    monkeypatch.setattr(BGVContext, "decrypt", watched)
    client, _, ok = run_in_process(psi, ht, device="cpu")
    assert ok and sorted(map(tuple, client.intersection_calculated)) == want
    assert calls and set(calls) == {scheme} and not outside
    assert client.noise_bits is not None  # the host decrypt's estimate, as before


def _role(module, role):
    """The module's PSIClient or PSIServer class."""
    return next(getattr(module, n) for n in dir(module) if n.endswith(f"PSI{role}"))


@pytest.mark.parametrize("case", sorted(BGV_AND_SIMPLE))
@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_mixed_jax_and_port_bgv_and_simple_fhe(capsys, direction, case):
    psi, ht = _case(case)
    jp, tp = (j_proto, t_proto) if psi.batched else (j_simple, t_simple)
    cpu = {"device": "cpu"}
    if direction == "jax_client_port_server":
        pair = (_role(jp, "Client"), _role(tp, "Server"), {}, cpu)
    else:
        pair = (_role(tp, "Client"), _role(jp, "Server"), cpu, {})
    client, _, ok = _mixed(*pair[:2], psi, ht, *pair[2:])
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == psi.intersection_set_size


ELGAMAL_SMALL = dict(fhe=False, server_set_size=60, client_set_size=4,
                     intersection_set_size=2, curve_name="P-192")
ELGAMAL_HT = dict(each_simple_table_size=8, each_cuckoo_table_size=6,
                  max_items_per_position=3)


def test_port_slice_runs_without_jax():
    """A fresh interpreter imports the port, runs its small CPU slice
    (BatchedFHE under BFV and --bgv, SimpleFHE, SimpleElGamal and
    PrecompElGamal), and never loads jax, the JAX package or cryptography."""
    runs = [(small_params(), small_ht()), _case("bgv16_leveled"), _case("simple_bfv"),
            (small_params(**ELGAMAL_SMALL), small_ht(**ELGAMAL_HT)),
            (small_params(**ELGAMAL_SMALL, precomp=True), small_ht(**ELGAMAL_HT))]
    code = (
        "import sys\n"
        "from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams\n"
        "from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process\n"
        "import nested_hashing_psi_tpu_torch.cli, nested_hashing_psi_tpu_torch.convert\n"
        f"runs = {[(dataclasses.asdict(p), dataclasses.asdict(h)) for p, h in runs]!r}\n"
        "for psi, ht in runs:\n"
        "    _, _, ok = run_in_process(PSIParams(**psi), HashTableParams(**ht), device='cpu')\n"
        "    assert ok\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'nested_hashing_psi_tpu' not in sys.modules\n"
        "assert 'cryptography' not in sys.modules\n"
        "print('NO_JAX_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("Set matches!") == len(runs) and "NO_JAX_OK" in res.stdout


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_in_process(small_params(), small_ht(), device="cuda")
    assert cli.parse_args(["-F", "--batched"])[2] == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["client", "-F", "--batched", "--port", "1"])


def test_unported_options_raise(capsys):
    """No option is left unported: the flags without -F choose SimpleElGamal,
    and with -P PrecompElGamal, and both verify in the port."""
    for precomp, name in ((True, "PrecompP-192"), (False, "SimpleP-192")):
        client, _, ok = run_in_process(small_params(**ELGAMAL_SMALL, precomp=precomp),
                                       small_ht(**ELGAMAL_HT), device="cpu")
        assert ok and client.protocol_name == name
        assert len(client.intersection_calculated) == 2
    assert capsys.readouterr().out.count("Set matches!") == 2


def test_cli_two_processes_over_tcp():
    """The port's CLI as two OS processes on localhost, --device cpu."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    flags = ["-F", "--batched", "-B", "16", "-S", "300", "-C", "12", "-I", "5",
             "-e", "32", "-E", "12", "-b", "4", "--ringDim", "128",
             "--numLimbs", "8", "--port", str(port), "--device", "cpu"]
    cmd = [sys.executable, "-m", "nested_hashing_psi_tpu_torch.cli"]
    server = subprocess.Popen(cmd + ["server"] + flags, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = subprocess.run(cmd + ["client"] + flags, cwd=REPO,
                                capture_output=True, text=True, timeout=300)
        assert client.returncode == 0, client.stderr[-3000:]
        assert "Set matches!" in client.stdout
        assert server.wait(timeout=120) == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
