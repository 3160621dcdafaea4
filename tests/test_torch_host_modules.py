"""The port's own copies of the JAX package's host modules (config, hashing,
data input, protocol base and channel, the native helpers) against the
originals, on the CPU: the same parameters from the same argv, the same
hashes, tables and input sets from the same seeds, byte-identical channel
frames. A subprocess runs the port with the JAX package made unimportable
and checks that neither it nor jax is ever loaded, including in the
spawned workers of the parallel table build."""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from nested_hashing_psi_tpu import config as j_config
from nested_hashing_psi_tpu.data import input as j_input
from nested_hashing_psi_tpu.hashing import cuckoo as j_cuckoo
from nested_hashing_psi_tpu.hashing import hierarchical as j_hier
from nested_hashing_psi_tpu.hashing import tabulation as j_tab
from nested_hashing_psi_tpu.protocol import base as j_base
from nested_hashing_psi_tpu.protocol import channel as j_channel
from nested_hashing_psi_tpu.utils import native as j_native
from nested_hashing_psi_tpu_torch import config as t_config
from nested_hashing_psi_tpu_torch import hashing as t_hashing
from nested_hashing_psi_tpu_torch.data import input as t_input
from nested_hashing_psi_tpu_torch.hashing import cuckoo as t_cuckoo
from nested_hashing_psi_tpu_torch.hashing import hierarchical as t_hier
from nested_hashing_psi_tpu_torch.hashing import tabulation as t_tab
from nested_hashing_psi_tpu_torch.protocol import base as t_base
from nested_hashing_psi_tpu_torch.protocol import channel as t_channel
from nested_hashing_psi_tpu_torch.utils import native as t_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = {
    "defaults": [],
    "main_path": ["-F", "--batched", "-B", "32", "-S", "1048576", "-C", "2048", "-I", "1024",
                  "-e", "8022", "-E", "12", "-b", "12", "-k", "2", "-K", "2"],
    "every_flag": ["-v", "-p", "-P", "-t", "4", "-s", "-c", "--stash", "3", "--seed", "7",
                   "--itemSeed", "8", "--ip", "10.0.0.1", "--port", "9", "--curve", "K-283",
                   "--bgv", "--ringDim", "128", "--numLimbs", "8", "--streamChunks", "4",
                   "--queries", "2"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_params_from_args_equal(name):
    argv = ARGVS[name]
    tp, th = t_config.params_from_args(t_config.build_arg_parser().parse_args(argv))
    jp, jh = j_config.params_from_args(j_config.build_arg_parser().parse_args(argv))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    assert th.batch_slots == jh.batch_slots
    assert dataclasses.asdict(t_config.PSIParams()) == dataclasses.asdict(j_config.PSIParams())
    assert dataclasses.asdict(t_config.HashTableParams()) == \
        dataclasses.asdict(j_config.HashTableParams())


@pytest.mark.parametrize("seed", [1, 987654321])
def test_tabulation_hashes_equal(seed):
    t, j = t_tab.TabulationHashing(seed, 4), j_tab.TabulationHashing(seed, 4)
    np.testing.assert_array_equal(t.table, j.table)
    items = np.random.default_rng(seed).integers(0, 2**64, size=(500, 2), dtype=np.uint64)
    np.testing.assert_array_equal(t.hash_all(items), j.hash_all(items))
    for h in range(4):
        np.testing.assert_array_equal(t.hash_index(items, h, 1000), j.hash_index(items, h, 1000))
    vals = [2, 65535, 2**64 - 1, 2**64, 2**127 - 1]
    np.testing.assert_array_equal(t_tab.items_from_ints(vals), j_tab.items_from_ints(vals))
    assert t_tab.items_to_ints(items[:7]) == j_tab.items_to_ints(items[:7])


@pytest.mark.parametrize("multi_table,stash", [(True, 0), (False, 4)])
def test_cuckoo_tables_equal(multi_table, stash):
    items = t_input.RandomDataInput(400, 100, 30, 11, 32).get_client_set()
    misses = t_input.RandomDataInput(400, 100, 30, 12, 32).get_client_set()[:70]
    tables = []
    for mod, tab in ((t_cuckoo, t_tab), (j_cuckoo, j_tab)):
        ct = mod.CuckooHashTable(tab.TabulationHashing(99, 3), 128, n_hash_functions=3,
                                 max_stash_size=stash, multi_table=multi_table,
                                 max_items_per_position=2, seed=4)
        ct.insert_all(items)
        tables.append((ct.table, ct.stash, ct.lookup(items), ct.lookup(misses)))
    for a, b in zip(*tables):
        np.testing.assert_array_equal(a, b)
    assert tables[0][2].all()


@pytest.mark.parametrize("n_workers", [1, 2], ids=["serial", "parallel"])
def test_hierarchical_tables_equal(n_workers):
    """The serial build and the spawned multi-process build give the JAX
    package's tables (each worker's eviction stream is seeded the same)."""
    items = t_input.RandomDataInput(600, 20, 5, 3, 32).get_server_set()
    tables = []
    for cfg, mod, tab in ((t_config, t_hier, t_tab), (j_config, j_hier, j_tab)):
        ht = cfg.HashTableParams(each_simple_table_size=16, each_cuckoo_table_size=24,
                                 server_stash_size=2, max_items_per_position=4)
        hct = mod.HierarchicalCuckooHashTable.from_params(tab.TabulationHashing(321, 4), ht,
                                                          seed=5)
        hct.insert_all(items, chunk_items=256, n_workers=n_workers)
        tables.append((hct.table, hct.stash))
    np.testing.assert_array_equal(tables[0][0], tables[1][0])
    np.testing.assert_array_equal(tables[0][1], tables[1][1])
    assert (tables[0][0] != 0).any(axis=-1).sum() + (tables[0][1] != 0).any(axis=-1).sum() \
        == 2 * len(items)
    for name in ("TabulationHashing", "CuckooHashTable", "CuckooFailure",
                 "HierarchicalCuckooHashTable"):
        assert getattr(t_hashing, name).__module__.startswith("nested_hashing_psi_tpu_torch.")


@pytest.mark.parametrize("sizes,bits", [((300, 12, 5), 16), ((2000, 64, 20), 32),
                                        ((500, 40, 0), 64), ((100, 10, 3), 80)])
def test_input_sets_equal(sizes, bits):
    t = t_input.RandomDataInput(*sizes, 123456789, bits)
    j = j_input.RandomDataInput(*sizes, 123456789, bits)
    for get in ("get_server_set", "get_client_set", "get_intersection_set"):
        np.testing.assert_array_equal(getattr(t, get)(), getattr(j, get)())
    tf, jf = t_input.FixedDataInput(*sizes, bits), j_input.FixedDataInput(*sizes, bits)
    for get in ("get_server_set", "get_client_set", "get_intersection_set"):
        np.testing.assert_array_equal(getattr(tf, get)(), getattr(jf, get)())


FRAMES = [
    np.arange(2 * 3 * 4, dtype=np.uint32).reshape(2, 3, 4),
    np.array([1, 2**64 - 1], dtype=np.uint64),
    np.array([[-5, 7]], dtype=np.int64),
    np.frombuffer(b"\x02compressed-point", dtype=np.uint8),
    np.zeros((0, 5), dtype=np.uint32),
]


def test_channel_frames_byte_identical():
    for arr in FRAMES:
        buf = t_channel.tensor_to_bytes(arr)
        assert buf == j_channel.tensor_to_bytes(arr)
        np.testing.assert_array_equal(j_channel.tensor_from_bytes(buf), arr)
        np.testing.assert_array_equal(t_channel.tensor_from_bytes(buf), arr)
    for bad in (b"XXXX\x03<u4\x00", t_channel.tensor_to_bytes(FRAMES[0])[:-1],
                b"NHP1\x03<f8\x00"):
        for mod in (t_channel, j_channel):
            with pytest.raises(mod.WireFormatError):
                mod.tensor_from_bytes(bad)
    assert t_channel.MAX_MSG_BYTES == j_channel.MAX_MSG_BYTES
    assert t_base.PHASE_SIGNAL_BYTES == j_base.PHASE_SIGNAL_BYTES


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tcp_frames_cross_packages(writer):
    """A port TCPChannel and a JAX one on the two ends of a localhost TCP
    connection: the same frames, the same byte counters, both ways."""
    with socket.create_server(("127.0.0.1", 0)) as srv:
        a = socket.create_connection(srv.getsockname(), timeout=10)
        b, _ = srv.accept()
    mods = (t_channel, j_channel) if writer == "port" else (j_channel, t_channel)
    w, r = mods[0].TCPChannel(a), mods[1].TCPChannel(b)
    try:
        for arr in FRAMES:
            w.write_tensor(arr)
            got = r.read_tensor()
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)
        w.write_msg(b"")
        assert r.read_msg() == b""
        assert w.bytes_out == r.bytes_in > 0
    finally:
        w.close()
        r.close()


def test_loopback_counts_like_jax():
    tc, ts = t_channel.LoopbackChannel.pair()
    jc, js = j_channel.LoopbackChannel.pair()
    for arr in FRAMES:
        tc.write_tensor(arr)
        jc.write_tensor(arr)
        np.testing.assert_array_equal(ts.read_tensor(), js.read_tensor())
    assert (tc.bytes_out, ts.bytes_in) == (jc.bytes_out, js.bytes_in)
    ts.poison()
    with pytest.raises(ConnectionError):
        tc.read_msg()


def test_protocol_base_export_names_equal(tmp_path):
    psi = t_config.PSIParams(server_set_size=300, client_set_size=12, number_of_threads=2)
    data = t_input.FixedDataInput(300, 12, 5)
    ch = t_channel.LoopbackChannel.pair()[0]
    for t_cls, j_cls in ((t_base.PSIClientBase, j_base.PSIClientBase),
                         (t_base.PSIServerBase, j_base.PSIServerBase)):
        t_obj = t_cls(data, psi, ch, "BatchedFHE", export_dir=str(tmp_path))
        j_obj = j_cls(data, psi, ch, "BatchedFHE", export_dir=str(tmp_path))
        assert t_obj.export_path == j_obj.export_path


NATIVE_T = (1 << 32) + (1 << 20) + (1 << 19) + 1
NATIVE_N = 64


def _jax_native_loaded():
    """The JAX package's native library, only if this process already loaded
    it: its loader writes the .so in place, so building it here could race a
    test in another worker (a half-written file fails to load)."""
    return j_native._lib


def _exact_phase_to_mt(phase, qs, t, scheme):
    """Python-int CRT decode: x = CRT(phase) in [0, q); BFV m = round(t x / q)
    mod t, BGV m = centred(x) mod t. The noise fraction is the distance of
    t x / q (BFV) or x / q (BGV) from the nearest integer, maximised."""
    from fractions import Fraction

    q = 1
    for p in qs:
        q *= p
    lead, n = phase.shape[:-2], phase.shape[-1]
    rows = phase.reshape(-1, len(qs), n)
    out = np.zeros((rows.shape[0], n), np.uint64)
    dist = Fraction(0)
    for r in range(rows.shape[0]):
        for j in range(n):
            x = sum(int(rows[r, i, j]) * (q // p) * pow(q // p, -1, p)
                    for i, p in enumerate(qs)) % q
            num = t * x if scheme == "bfv" else x
            k = (2 * num + q) // (2 * q)  # round(num / q), halves up
            dist = max(dist, abs(Fraction(num, q) - k))
            out[r, j] = k % t if scheme == "bfv" else (x - k * q) % t
    return out.reshape(*lead, n), dist


@pytest.mark.parametrize("case", ["ntt_mod_t-forward", "ntt_mod_t-inverse",
                                  "phase_to_mt-bfv", "phase_to_mt-bgv"])
def test_native_helpers_equal(case):
    """The port's native helpers against exact Python-integer references
    that need no build, and against the JAX package's library where this
    process has it loaded already."""
    from nested_hashing_psi_tpu.fhe.encoding import _ntt_object
    from nested_hashing_psi_tpu_torch.fhe.encoding import PackedEncoder
    from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

    t, n = NATIVE_T, NATIVE_N
    helper, arg = case.split("-")
    j_lib = _jax_native_loaded()
    if helper == "ntt_mod_t":
        inverse = arg == "inverse"
        psi = PackedEncoder(n, t).psi
        x = np.random.default_rng(5).integers(0, t, size=(3, n), dtype=np.uint64)
        got = t_native.ntt_mod_t(x, t, psi, inverse)
        assert got is not None  # the port's own build is atomic and cannot race
        want = _ntt_object(x.astype(object), t, psi, inverse).astype(np.uint64)
        np.testing.assert_array_equal(got, want)
        if j_lib is not None:
            np.testing.assert_array_equal(got, j_native.ntt_mod_t(x, t, psi, inverse))
        return
    qs = ntt_primes(4, 31, 2 * n, (t,))
    phase = (np.random.default_rng(6).integers(0, 1 << 62, size=(2, 4, n))
             % np.array(qs, np.int64).reshape(4, 1)).astype(np.uint64)
    got = t_native.phase_to_mt(phase, qs, t, arg)
    assert got is not None
    m_t, d_t = got
    m_want, d_want = _exact_phase_to_mt(phase, qs, t, arg)
    np.testing.assert_array_equal(m_t, m_want)
    # the native noise fraction sums L fixed-point terms, each truncated by
    # less than q_i * 2^-64 < 2^-33
    assert abs(d_t - float(d_want)) <= len(qs) * 2.0**-33
    assert 0.0 <= d_t <= 0.5
    if j_lib is not None:
        m_j, d_j = j_native.phase_to_mt(phase, qs, t, arg)
        np.testing.assert_array_equal(m_t, m_j)
        assert d_t == d_j


_NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    def main():
        import nested_hashing_psi_tpu_torch as pkg
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(info.name)
        from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
        from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
        from nested_hashing_psi_tpu_torch.hashing import (
            HierarchicalCuckooHashTable, TabulationHashing)
        from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process

        psi = PSIParams(server_set_size=300, client_set_size=12, intersection_set_size=5,
                        bit_size=32, fhe=True, batched=True, ring_dim=128, num_limbs=10)
        ht = HashTableParams(each_simple_table_size=32, each_cuckoo_table_size=12,
                             max_items_per_position=4)
        _, _, ok = run_in_process(psi, ht, device="cpu")
        assert ok
        items = RandomDataInput(600, 20, 5, 3, 32).get_server_set()
        hct = HierarchicalCuckooHashTable.from_params(TabulationHashing(321, 4), ht, seed=5)
        hct.insert_all(items, n_workers=2)
        assert (hct.table != 0).any(axis=-1).sum() == 2 * len(items)
        from nested_hashing_psi_tpu_torch.benchmarks import (
            bench_ntt_anatomy, bench_ntt_lazy_probe, bench_vpu_ops)
        bench_vpu_ops.main(["--device", "cpu", "--shape", "1", "8", "128", "--iters", "1"])
        for probe in (bench_ntt_lazy_probe, bench_ntt_anatomy):
            probe.main(["--device", "cpu", "--n", "1024", "--limbs", "1", "--batch", "2",
                        "--iters", "1"])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "nested_hashing_psi_tpu."))
                     or m == "nested_hashing_psi_tpu")
        assert not bad, bad
        print("PORT_STANDS_ALONE")

    if __name__ == "__main__":
        main()
""")


def test_port_imports_nothing_of_jax_or_the_jax_package(tmp_path):
    """Every port module imported, a whole protocol run, a two-worker
    parallel table build and the three probes' CPU runs, in a fresh interpreter where the JAX package
    cannot be imported (a stub that raises shadows it, for the spawned
    workers too); afterwards neither it nor jax is in sys.modules."""
    stub = tmp_path / "stub" / "nested_hashing_psi_tpu"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        "raise ImportError('the port must not import the JAX package')\n")
    script = tmp_path / "port_alone.py"
    script.write_text(_NO_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub.parent), REPO]))
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Set matches!" in res.stdout and "PORT_STANDS_ALONE" in res.stdout
    assert res.stdout.count("G applications/s") == 11
    assert "[ntt_lazy]" in res.stdout and "[ntt_anatomy]" in res.stdout
