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


def _in_buffer(frame: bytes, payload: int) -> np.ndarray:
    """``frame`` held in a uint8 array (not ``bytes``), its last ``payload``
    bytes starting 16-byte aligned behind a pad, as ``convert.send`` writes
    a GPU tensor's frame in place."""
    header = len(frame) - payload
    raw = np.zeros(len(frame) + 32, np.uint8)
    pad = -(raw.ctypes.data + header) % 16
    buf = raw[pad : pad + len(frame)]
    buf[:] = np.frombuffer(frame, np.uint8)
    assert (buf.ctypes.data + header) % 16 == 0 and buf.base is not None
    return buf


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_frame_header_writes_the_jax_frame(k):
    """The one header writer (``tensor_to_bytes`` and the frames written in
    place take it), followed by the payload, is the JAX package's frame."""
    arr = FRAMES[k]
    header = t_channel.frame_header(arr.dtype, arr.shape)
    assert header + arr.tobytes() == j_channel.tensor_to_bytes(arr)
    assert len(header) == 6 + len(arr.dtype.str) + 8 * arr.ndim


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_frame_in_a_buffer_parses_like_bytes(k):
    arr = FRAMES[k]
    frame = j_channel.tensor_to_bytes(arr)
    got = t_channel.tensor_from_bytes(_in_buffer(frame, arr.nbytes))
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)


BAD_FRAMES = {
    "short": b"NHP1",
    "magic": b"XXXX\x03<u4\x00",
    "header": b"NHP1\x05<u4",
    "dtype": b"NHP1\x03<f8\x00",
    "rank": b"NHP1\x03<u4\x09",
    "shape": b"NHP1\x03<u4\x02" + bytes(8),
    "negative": b"NHP1\x03<u4\x01" + (-1).to_bytes(8, "little", signed=True),
    "payload": j_channel.tensor_to_bytes(FRAMES[0])[:-1],
}


@pytest.mark.parametrize("name", list(BAD_FRAMES))
def test_bad_frame_in_a_buffer_raises_like_bytes(name):
    """Every refusal of ``tensor_from_bytes`` on bytes, with its message,
    holds for the same frame in a uint8 array; JAX refuses the bytes too."""
    frame = BAD_FRAMES[name]
    with pytest.raises(j_channel.WireFormatError):
        j_channel.tensor_from_bytes(frame)
    with pytest.raises(t_channel.WireFormatError) as as_bytes:
        t_channel.tensor_from_bytes(frame)
    with pytest.raises(t_channel.WireFormatError) as in_buffer:
        t_channel.tensor_from_bytes(_in_buffer(frame, 0))
    assert str(in_buffer.value) == str(as_bytes.value)


def test_loopback_carries_buffer_frames_and_counts_like_jax():
    """A frame in a uint8 array crosses the port's loopback by reference and
    is counted as the JAX loopback counts the same frame sent as bytes."""
    tc, ts = t_channel.LoopbackChannel.pair()
    jc, js = j_channel.LoopbackChannel.pair()
    for arr in FRAMES:
        buf = _in_buffer(j_channel.tensor_to_bytes(arr), arr.nbytes)
        tc.write_msg(buf)
        jc.write_tensor(arr)
        msg = ts.read_msg()
        assert msg is buf
        got = t_channel.tensor_from_bytes(msg)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, js.read_tensor())
    assert (tc.bytes_out, ts.bytes_in) == (jc.bytes_out, js.bytes_in)
    tc.write_msg(np.zeros(4, np.uint32))  # not a frame: refused on reading
    with pytest.raises(t_channel.WireFormatError):
        ts.read_msg()


def test_send_to_a_channel_that_takes_bytes_sends_bytes():
    """``convert.send`` hands the JAX loopback (which takes no buffer frame)
    bytes, for a tensor and a host array; the port's loopback gets bytes for
    every frame but a GPU tensor's."""
    import torch

    from nested_hashing_psi_tpu_torch import convert

    t = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    meta = np.array([7, 1], np.uint64)
    for mod in (j_channel, t_channel):
        w, r = mod.LoopbackChannel.pair()
        sent, write = [], w.write_msg
        w.write_msg = lambda msg: (sent.append(type(msg)), write(msg))
        for x in (t, meta):
            convert.send(w, x)
            got = convert.receive(r)
            want = x.numpy().view(np.uint32) if isinstance(x, torch.Tensor) else x
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert sent == [bytes, bytes]


@pytest.mark.parametrize("shape,cut", [((2, 3, 4), None), ((0, 5), None),
                                       ((2, 3, 2, 6, 16), None), ((2, 3, 2, 6, 16), 2)],
                         ids=["small", "empty", "index", "index_chunk"])
def test_frame_written_in_place_is_the_jax_frame(shape, cut):
    """``convert.send``'s frame of a GPU tensor, written here in place for a
    CPU tensor (pageable), a streamed chunk's strided slice among them: the
    JAX package's bytes, the payload 16-byte aligned, and ``base`` a tensor
    over exactly the frame; it crosses the loopback and reads back."""
    import torch

    from nested_hashing_psi_tpu_torch import convert

    rng = np.random.default_rng(len(shape))
    t = torch.from_numpy(rng.integers(0, 2**31 - 1, size=shape).astype(np.int32))
    if cut is not None:
        t = t[:, :cut]
    arr = np.ascontiguousarray(t.numpy()).view(np.uint32)
    frame = convert._frame_in_place(t)
    assert bytes(frame) == j_channel.tensor_to_bytes(arr)
    assert (frame.ctypes.data + len(frame) - arr.nbytes) % 16 == 0
    assert isinstance(frame.base, torch.Tensor) and frame.base.numel() == len(frame)
    assert frame.base.data_ptr() == frame.ctypes.data
    assert not frame.base.is_pinned()  # page-locked only for a GPU tensor
    w, r = t_channel.LoopbackChannel.pair()
    w.write_msg(frame)
    assert torch.equal(convert.receive(r, "cpu"), t)


@pytest.mark.parametrize("writer", ["port", "jax", "port_buffer"])
def test_tcp_frames_cross_packages(writer):
    """A port TCPChannel and a JAX one on the two ends of a localhost TCP
    connection: the same frames, the same byte counters, both ways; a port
    channel writing a frame held in a uint8 array delivers the same bytes."""
    with socket.create_server(("127.0.0.1", 0)) as srv:
        a = socket.create_connection(srv.getsockname(), timeout=10)
        b, _ = srv.accept()
    mods = (j_channel, t_channel) if writer == "jax" else (t_channel, j_channel)
    w, r = mods[0].TCPChannel(a), mods[1].TCPChannel(b)
    try:
        for arr in FRAMES:
            if writer == "port_buffer":
                w.write_msg(_in_buffer(j_channel.tensor_to_bytes(arr), arr.nbytes))
            else:
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
        import os, tempfile
        from nested_hashing_psi_tpu_torch.benchmarks import bench_e2e_psi, profile_build
        from nested_hashing_psi_tpu_torch.utils import checkpoint, profiling

        os.environ["NHPSI_RING_DIM"] = "128"
        with tempfile.TemporaryDirectory() as d:
            art = os.path.join(d, "artifact")
            row = ["--server-log2", "9", "--client-log2", "4", "--device", "cpu"]
            assert bench_e2e_psi.main(row + ["--checkpoint", art, "--buildOnly"]) == 0
            assert bench_e2e_psi.main(["--resume", art, "--device", "cpu"]) == 0
            checkpoint.save_batched_pie(os.path.join(d, "again"),
                                        checkpoint.load_batched_pie(art, device="cpu"))
            with profiling.device_trace(os.path.join(d, "trace")):
                profile_build.main(["11", "--simpleSize", "32", "--inner", "8",
                                    "--device", "cpu"])
        import numpy as np
        import torch
        from nested_hashing_psi_tpu_torch.ops import ntt4  # noqa: F401
        from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, ntt
        from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes
        from nested_hashing_psi_tpu_torch.parallel import (  # noqa: F401
            comm, dist_ntt, launch, mesh, multihost)
        import torch_parallel_cases as cases

        ps = tuple(ntt_primes(2, 31, 128))
        x = np.random.default_rng(3).integers(0, min(ps), size=(2, 64)).astype(np.uint32)
        case = dict(name="ring", kind="ring_ntt", params=(64, ps, 0), inputs={"x": x})
        (fwd, back), = cases.summarize(
            launch.run_ranks(cases.run_cases, 2, "gloo", ([case], "cpu"), 120))[0]["results"],
        want = ntt(torch.from_numpy(x.view(np.int32)), NTTPlan(64, ps)).numpy().view(np.uint32)
        assert (fwd == want).all() and (back == x).all()
        print("RANKS_STAND_ALONE")
        from nested_hashing_psi_tpu_torch.benchmarks import (
            bench, bench_ntt_f32mxu, bench_ntt_kernel, bench_pie_online, comm_model,
            profile_online, run_eval, scaling_report, small_pie, summarize_eval, timing)
        from nested_hashing_psi_tpu_torch.hashing import evaluation

        assert evaluation.evaluate_flat(128, 1, slacks=(2.0,))[0][2] == 0
        cpu = torch.device("cpu")
        built = small_pie.bench_row(device=cpu, ring=512, simple=64, D=2, P=4)
        bench.headline(bench.ntt_rates(cpu, n=64, limbs=2, hbm_batch=2, l2_batch=1),
                       bench.pie_online(built, cpu, queries=2, iters=1, steady_iters=1), cpu)
        profile_online.hps_rows(built, cpu, iters=1)
        bench_pie_online.run("small", cpu, ring=1024, iters=1)
        bench_ntt_kernel.rates("split", 2, cpu, n=256, limbs=2, iters=1)
        bench_ntt_f32mxu.run(cpu, m=16, tb=1, n=256, batch=1, iters=1)
        comm_model.main(["--link-GBps", "100"])
        summarize_eval.main([os.path.join(timing.ROOT, "eval_results")])
        with tempfile.TemporaryDirectory() as d:
            tsv = os.path.join(d, "rows.tsv")
            with open(tsv, "w") as f:
                f.write("serverSetSize\\tclientSetSize\\tintersectionSetSize\\t"
                        "eachSimpleTableSize\\teachCuckooTableSize\\tnSimpleHF\\tmaxPP\\n"
                        "300\\t12\\t5\\t32\\t12\\t2\\t4\\n")
            assert run_eval.main(["--params", tsv, "--outdir", d, "--device", "cpu"])[0][1]
        rep = scaling_report.main(["--device", "cpu", "--ring", "64", "--limbs", "4",
                                   "--depths", "4", "--positions", "4", "--iters", "1",
                                   "--ranks", "2"])
        assert all(r.get("bit_equal", True) for r in rep["rows"])
        print("TOOLS_STAND_ALONE")
        from nested_hashing_psi_tpu_torch.ops import refmodel
        from nested_hashing_psi_tpu_torch.ops.basis import BasisExtension
        from nested_hashing_psi_tpu_torch.utils import native
        import torch_golden_cases as goldens

        p = ntt_primes(1, 31, 32)[0]
        assert refmodel.negacyclic_mul_naive(np.ones(16), np.ones(16), p)[15] == 16
        BasisExtension(ps, ntt_primes(3, 31, 128, avoid=ps)).convert(
            torch.from_numpy(x.view(np.int32)))
        assert native.cuckoo_insert_seq(np.ones((1, 2), np.uint64), np.ones((1, 16, 256),
                                        np.uint64), 0, 1, 4, 1, True, 0, 1)[2] == 0
        assert goldens.golden_inner_product("cpu", 16)["slots"] == [0, 1, 0, 1]
        assert goldens.golden_batched_fhe_pie("cpu", 16)["zeros"].sum() == 2
        print("GOLDENS_STAND_ALONE")
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
    parallel table build, the three probes' CPU runs, the end-to-end bench's
    --buildOnly and --resume (utils.checkpoint) and the build profiler under
    utils.profiling's trace, the ring-exchange NTT in two spawned gloo
    ranks (parallel.launch, the tests' rank program), and every bench and
    eval tool (hashing.evaluation and benchmarks/: bench, profile_online,
    bench_pie_online, bench_ntt_kernel, bench_ntt_f32mxu, comm_model,
    summarize_eval, run_eval, scaling_report with two spawned gloo ranks),
    ops.refmodel, BasisExtension, the native cuckoo insert and the goldens'
    module (tests/torch_golden_cases.py: TestFHEInnerP and TestBatchedFHEPIE
    at ring 16) at small sizes on the CPU, in a fresh interpreter where
    neither jax nor the JAX package can be imported (stubs that raise shadow them, for the
    spawned workers and ranks too); afterwards neither is in sys.modules."""
    for name in ("nested_hashing_psi_tpu", "jax"):
        stub = tmp_path / "stub" / name
        stub.mkdir(parents=True)
        (stub / "__init__.py").write_text(
            f"raise ImportError('the port must not import {name}')\n")
    script = tmp_path / "port_alone.py"
    script.write_text(_NO_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub.parent), REPO,
                                                       os.path.join(REPO, "tests")]))
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Set matches!" in res.stdout and "PORT_STANDS_ALONE" in res.stdout
    assert "RANKS_STAND_ALONE" in res.stdout and "TOOLS_STAND_ALONE" in res.stdout
    assert "GOLDENS_STAND_ALONE" in res.stdout
    assert res.stdout.count("G applications/s") == 11
    assert "[ntt_lazy]" in res.stdout and "[ntt_anatomy]" in res.stdout
    assert "RESUME RESULT: Set matches!" in res.stdout and "[profile_build] {" in res.stdout
