"""The port's ElGamal track (crypto/elgamal.py, crypto/damgard_jurik.py,
utils/prg.py, pie/elgamal.py, protocol/elgamal.py, protocol/dj_pair.py)
against the JAX package, on the CPU.

- AddHomElGamal: the reference's primitive checks, and every gadget with the
  same seeded ``rng`` in both packages, ciphertext bytes equal;
- both PIE engines, seeded, their output lists byte-equal;
- Damgard-Jurik and the DJ socket pair (the cases of test_misc_crypto.py,
  seeded parity of the keys, and mixed pairs);
- AesCtrPrg on the NIST SP 800-38A F.5.1 CTR-AES128 vectors;
- SimpleElGamal and PrecompElGamal over loopback: port-only (with a stash,
  -s/-c combined tables and --nThreads 2), mixed JAX <-> port both ways on
  P-192 and one SimpleElGamal run on K-163, each verifying with the JAX
  runner's intersection; the CLI as two OS processes (no -F, and -P).
The ElGamal runner on the card is in test_torch_kernels_gpu.py.

Every JAX party takes the JAX package's pure-Python group law
(``jax_pure_python_ec``): both laws give the same affine points, and no port
test starts the JAX package's in-place native build.
"""

import dataclasses
import os
import random
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from nested_hashing_psi_tpu import config as j_config
from nested_hashing_psi_tpu.config import HashTableParams as JHT
from nested_hashing_psi_tpu.config import PSIParams as JPSI
from nested_hashing_psi_tpu.crypto import damgard_jurik as j_dj
from nested_hashing_psi_tpu.crypto import ec as j_ec
from nested_hashing_psi_tpu.crypto import elgamal as j_eg
from nested_hashing_psi_tpu.data.input import RandomDataInput as JData
from nested_hashing_psi_tpu.pie import elgamal as j_pie
from nested_hashing_psi_tpu.protocol import dj_pair as j_dj_pair
from nested_hashing_psi_tpu.protocol import elgamal as j_proto
from nested_hashing_psi_tpu.protocol.channel import LoopbackChannel as JLoop
from nested_hashing_psi_tpu.protocol.runner import run_in_process as j_run
from nested_hashing_psi_tpu.utils import native_ec as j_native_ec
from nested_hashing_psi_tpu.utils import native_ec2m as j_native_ec2m
from nested_hashing_psi_tpu_torch import config as t_config
from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.crypto import damgard_jurik as t_dj
from nested_hashing_psi_tpu_torch.crypto import ec as t_ec
from nested_hashing_psi_tpu_torch.crypto import elgamal as t_eg
from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
from nested_hashing_psi_tpu_torch.pie import elgamal as t_pie
from nested_hashing_psi_tpu_torch.protocol import dj_pair as t_dj_pair
from nested_hashing_psi_tpu_torch.protocol import elgamal as t_proto
from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel, TCPChannel
from nested_hashing_psi_tpu_torch.protocol.runner import run_in_process
from nested_hashing_psi_tpu_torch.utils.prg import AesCtrPrg, aes128_ctr_keystream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def jax_pure_python_ec(monkeypatch):
    """JAX parties use the pure-Python group law (no in-place build)."""
    monkeypatch.setattr(j_native_ec, "for_curve", lambda *a, **k: None)
    monkeypatch.setattr(j_native_ec2m, "for_curve", lambda *a, **k: None)


# ---------------------------------------------------------------------------
# AddHomElGamal (reference TestElGamal.cpp), the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eg():
    e = t_eg.AddHomElGamal(t_ec.EcGroup("P-192"))
    e.keygen()
    return e


def test_homomorphic_ops(eg):
    a, b = eg.encrypt(17), eg.encrypt(25)
    s = eg.add(a, b)
    assert eg.decrypts_to_zero(eg.add(s, eg.encrypt(-42)))
    d = eg.subtract(b, a)
    assert eg.decrypts_to_zero(eg.add(d, eg.encrypt(-8)))
    m = eg.mult_by_const(a, 3)
    assert eg.decrypts_to_zero(eg.add(m, eg.encrypt(-51)))


def test_xor_tricks(eg):
    assert eg.decrypts_to_zero(eg.xor_by_const(eg.encrypt(1), True))
    assert not eg.decrypts_to_zero(eg.xor_by_const(eg.encrypt(0), True))
    assert eg.decrypts_to_zero(eg.element_xor_by_const(eg.encrypt(99), 99))


def test_randomized_equality_gadgets(eg):
    minus, zero = eg.encrypt(-123), eg.encrypt_zero()
    assert eg.decrypts_to_zero(eg.randomized_equality(minus, eg.encrypt(123), zero))
    assert not eg.decrypts_to_zero(eg.randomized_equality(minus, eg.encrypt(124), zero))
    assert eg.decrypts_to_zero(eg.randomized_equality(minus, 123, zero))
    idx = [eg.encrypt(0), eg.encrypt(0), eg.encrypt(1), eg.encrypt(0)]
    table = [10, 20, 55, 70]
    assert eg.decrypts_to_zero(
        eg.indexed_randomized_equality(idx, table, eg.encrypt(-55), eg.encrypt_zero()))
    assert not eg.decrypts_to_zero(
        eg.indexed_randomized_equality(idx, table, eg.encrypt(-20), eg.encrypt_zero()))


def test_ct_serialization(eg):
    ct = eg.encrypt(777)
    back = eg.ct_from_bytes(eg.ct_to_bytes(ct))
    assert eg.decrypts_to_zero(eg.add(back, eg.encrypt(-777)))
    cts = eg.encrypt_batch([1, 2, 3, 4])
    data = b"".join(eg.ct_to_bytes(c) for c in cts)
    assert eg.cts_from_bytes(data, 4) == cts


# ---------------------------------------------------------------------------
# the same seeded gadgets in both packages: equal ciphertext bytes
# ---------------------------------------------------------------------------

def _gadget_trace(enc) -> list:
    """Every AddHomElGamal gadget once, in a fixed order, as wire bytes."""
    out = []
    ct = enc.ct_to_bytes
    pk, sk = enc.keygen()
    out += [enc.point_to_bytes(pk), sk]
    a, b, z = enc.encrypt(17), enc.encrypt(-25), enc.encrypt_zero()
    cts = enc.encrypt_batch([0, 1, 5, -3])
    zs = enc.encrypt_zero_batch(3)
    out += [ct(c) for c in [a, b, z, *cts, *zs]]
    out += [ct(enc.add(a, b)), ct(enc.subtract(a, b)), ct(enc.mult_by_const(a, 3))]
    out += [ct(c) for c in enc.mult_by_const_many(a, [2, 3, 4])]
    out += [ct(enc.element_xor_by_const(cts[1], 99)), ct(enc.xor_by_const(cts[1], True)),
            ct(enc.xor_by_const(cts[0], False))]
    out += [ct(enc.homomorphic_inner_product(cts, [10, 20, 30, 40]))]
    out += [ct(enc.randomized_equality(b, cts[2], z)), ct(enc.randomized_equality(b, 25, z))]
    out += [ct(c) for c in enc.randomized_equality_batch(b, cts[:3], zs)]
    out += [ct(enc.indexed_randomized_equality(cts, [1, 2, 3, 4], b, z))]
    out += [ct(enc.custom_indexed_randomized_equality(cts, [5, 6, 7, 8], b, z, 7))]
    out += [enc.point_to_bytes(enc.decrypt_element(a))]
    out += [enc.decrypts_to_zero_batch(cts), enc.decrypts_to_zero(cts[0])]
    data = b"".join(ct(c) for c in cts)
    out += [[ct(c) for c in enc.cts_from_bytes(data, 4)], ct(enc.ct_from_bytes(ct(a)))]
    return out


@pytest.mark.parametrize("curve", ["P-192", "P-256", "K-163"])
def test_gadgets_seeded_bytes_equal_jax(curve):
    t = _gadget_trace(t_eg.AddHomElGamal(t_ec.ec_group(curve), rng=random.Random(11)))
    j = _gadget_trace(j_eg.AddHomElGamal(j_ec.ec_group(curve), rng=random.Random(11)))
    assert t == j
    assert t[-4] == [True, False, False, False]


# ---------------------------------------------------------------------------
# the PIE engines, seeded in both packages: byte-equal output lists
# ---------------------------------------------------------------------------

PIE_CASES = {
    "simple": dict(multi_table=True, precalc=False),
    "simple_combined": dict(multi_table=False, precalc=False),
    "simple_precalc": dict(multi_table=True, precalc=True),
    "precomp": dict(multi_table=True, precomp=True),
    "precomp_combined": dict(multi_table=False, precomp=True),
}


def _pie_outputs(pkg_eg, pkg_ec, pkg_pie, case: dict) -> tuple[list, bool]:
    """One PIE of a (2 hash functions, 3 bins, 4 positions) table and a
    stash of one, seeded; the client's element equals the table value its
    index selects in bin 1. Returns (result bytes, some result is zero)."""
    H, bins, P = 2, 3, 4
    enc = pkg_eg.AddHomElGamal(pkg_ec.ec_group("P-192"), rng=random.Random(5))
    enc.keygen()
    rng = np.random.default_rng(9)
    n_tables = H if case["multi_table"] else 1
    table = rng.integers(1, 1 << 16, size=(n_tables, bins, P)).astype(object)
    stash = [int(rng.integers(1, 1 << 16))]
    pos = [1, 3]  # the client's index per hash function
    elem = int(table[0][1][pos[0]])
    if case.get("precomp"):
        pie = pkg_pie.PrecompElGamalPIE(enc, table, stash, case["multi_table"], H,
                                        rng=random.Random(6))
        bits = rng.integers(0, 2, size=H * P).astype(np.uint8)
        idx = enc.encrypt_batch([int(b) for b in bits])
        pie.index_matrix = [idx[h * P:(h + 1) * P] for h in range(H)]
        pie.precomp()
        pie.minus_elem = enc.encrypt(-elem)
        xor = bits.copy()
        for h in range(H):
            xor[h * P + pos[h]] ^= 1
        res = pie.run(xor)
    else:
        pie = pkg_pie.ElGamalPIE(enc, table, stash, case["multi_table"], H,
                                 precalc_random=case["precalc"], rng=random.Random(6))
        idx = enc.encrypt_batch([int(j == pos[h]) for h in range(H) for j in range(P)])
        pie.index_matrix = [idx[h * P:(h + 1) * P] for h in range(H)]
        pie.minus_elem = enc.encrypt(-elem)
        res = pie.run()
    assert len(res) == H * bins + len(stash)
    return [enc.ct_to_bytes(c) for c in res], any(enc.decrypts_to_zero_batch(res))


@pytest.mark.parametrize("case", sorted(PIE_CASES))
def test_pie_engines_seeded_bytes_equal_jax(case):
    t_out, t_hit = _pie_outputs(t_eg, t_ec, t_pie, PIE_CASES[case])
    j_out, j_hit = _pie_outputs(j_eg, j_ec, j_pie, PIE_CASES[case])
    assert t_out == j_out
    assert t_hit and j_hit


def test_pie_precalc_needs_multi_tables():
    enc = t_eg.AddHomElGamal(t_ec.ec_group("P-192"))
    enc.keygen()
    with pytest.raises(ValueError, match="multi tables"):
        t_pie.ElGamalPIE(enc, np.ones((1, 2, 2), object), [], False, 2, precalc_random=True)


# ---------------------------------------------------------------------------
# Damgard-Jurik (test_misc_crypto.py's cases) and the DJ pair
# ---------------------------------------------------------------------------

def test_damgard_jurik_roundtrip_and_homomorphism():
    dj = t_dj.DamgardJurik(modulus_bits=256, s=1)
    for m in (0, 1, 42, dj.n_s - 1):
        assert dj.decrypt(dj.encrypt(m)) == m
    a, b = 1234, 98765
    assert dj.decrypt(dj.add(dj.encrypt(a), dj.encrypt(b))) == a + b
    assert dj.decrypt(dj.mult_by_const(dj.encrypt(a), 7)) == 7 * a


def test_damgard_jurik_s2():
    dj = t_dj.DamgardJurik(modulus_bits=256, s=2)
    big = dj.n + 12345
    assert dj.decrypt(dj.encrypt(big)) == big
    assert dj.decrypt(dj.add(dj.encrypt(big), dj.encrypt(1))) == big + 1


@pytest.mark.parametrize("s", [1, 2])
def test_damgard_jurik_seeded_equal_jax(s):
    t = t_dj.DamgardJurik(modulus_bits=256, s=s, rng=random.Random(21))
    j = j_dj.DamgardJurik(modulus_bits=256, s=s, rng=random.Random(21))
    assert (t.n, t.d) == (j.n, j.d)
    assert [t.encrypt(m) for m in (0, 5, t.n_s - 1)] == [j.encrypt(m) for m in (0, 5, j.n_s - 1)]
    c = j.encrypt(31337)
    assert t.decrypt(c) == 31337
    pub = t_dj.DamgardJurik.from_public(t.n, s)
    assert t.decrypt(pub.add(pub.encrypt(3), pub.mult_by_const(pub.encrypt(4), 5))) == 23


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("pair", ["port", "jax_client_port_server", "port_client_jax_server"])
def test_dj_socket_pair_equality_protocol(pair, tmp_path):
    """The DJ pair over localhost sockets, matching and differing, plus the
    timing CSV; mixed with the JAX package's pair both ways."""
    from nested_hashing_psi_tpu.protocol.channel import TCPChannel as JTCP

    server_mod = j_dj_pair if pair == "port_client_jax_server" else t_dj_pair
    client_mod = j_dj_pair if pair == "jax_client_port_server" else t_dj_pair
    server_ch = JTCP if server_mod is j_dj_pair else TCPChannel
    client_ch = JTCP if client_mod is j_dj_pair else TCPChannel

    def once(differ: bool, export=None) -> bool:
        port = _free_port()

        def server():
            ch = server_ch.listen("127.0.0.1", port)
            try:
                server_mod.run_dj_server(ch, 8, export_path=export)
            finally:
                ch.close()

        th = threading.Thread(target=server, daemon=True)
        th.start()
        ch = client_ch.connect("127.0.0.1", port)
        try:
            ok = client_mod.run_dj_client(ch, 8, elem_index=3, differ=differ, modulus_bits=256)
        finally:
            ch.close()
        th.join(timeout=60)
        return ok

    csv = tmp_path / "M_S8_K256.csv"
    assert once(differ=False, export=str(csv)) is True
    assert once(differ=True) is False
    assert [r.split(",")[0] for r in csv.read_text().splitlines()] == [
        "Send Index Vector", "Multiplication", "Addition"]
    assert t_dj_pair._server_set(8) == j_dj_pair._server_set(8)


# ---------------------------------------------------------------------------
# AES-128-CTR without the cryptography package
# ---------------------------------------------------------------------------

# NIST SP 800-38A, F.5.1 CTR-AES128.Encrypt
SP800_38A_KEY = "2b7e151628aed2a6abf7158809cf4f3c"
SP800_38A_CTR = "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"
SP800_38A_PT = ("6bc1bee22e409f96e93d7e117393172a", "ae2d8a571e03ac9c9eb76fac45af8e51",
                "30c81c46a35ce411e5fbc1191a0a52ef", "f69f2445df4f9b17ad2b417be66c3710")
SP800_38A_CT = ("874d6191b620e3261bef6864990db6ce", "9806f66b7970fdff8617187bb9fffdff",
                "5ae4df3edbd5d35e5b4f09020db03eab", "1e031dda2fbe03d1792170a0f3009cee")


@pytest.mark.parametrize("first", [0, 1, 3])
def test_aes_ctr_sp800_38a_vectors(first):
    key, ctr = bytes.fromhex(SP800_38A_KEY), bytes.fromhex(SP800_38A_CTR)
    n = 4 - first
    stream = aes128_ctr_keystream(key, ctr, first, n)
    pt = bytes.fromhex("".join(SP800_38A_PT[first:]))
    assert bytes(a ^ b for a, b in zip(stream, pt)).hex() == "".join(SP800_38A_CT[first:])


def test_aes_ctr_counter_wraps_at_2_128():
    key = bytes.fromhex(SP800_38A_KEY)
    top = aes128_ctr_keystream(key, b"\xff" * 16, 0, 2)
    assert top[16:] == aes128_ctr_keystream(key, bytes(16), 0, 1)


def test_aes_ctr_prg_reset_reproduces_stream():
    prg = AesCtrPrg(b"0123456789abcdef")
    first = prg.get_bits(1000)
    more = prg.get_bits(64)
    prg.reset()
    again = np.concatenate([prg.get_bits(1000), prg.get_bits(64)])
    np.testing.assert_array_equal(np.concatenate([first, more]), again)
    other = AesCtrPrg(b"fedcba9876543210").get_bits(1000)
    assert not np.array_equal(first, other)


def test_aes_ctr_prg_equals_cryptography_and_jax():
    """The stream of the cryptography package's AES-CTR and of the JAX
    package's AesCtrPrg (which uses it), in uneven pieces."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    from nested_hashing_psi_tpu.utils.prg import AesCtrPrg as JPrg

    key = bytes(range(16))
    want = Cipher(algorithms.AES(key), modes.CTR(bytes(16))).encryptor().update(bytes(1000))
    prg = AesCtrPrg(key)
    got = b"".join(prg.get_bytes(n) for n in (1, 15, 16, 17, 100, 851))
    assert got == want
    np.testing.assert_array_equal(AesCtrPrg(key).get_bits(5001), JPrg(key).get_bits(5001))


# ---------------------------------------------------------------------------
# the protocols
# ---------------------------------------------------------------------------

def elgamal_params(**over):
    base = dict(server_set_size=60, client_set_size=4, intersection_set_size=2,
                bit_size=16, curve_name="P-192")
    base.update(over)
    return PSIParams(**base)


def elgamal_ht(**over):
    base = dict(each_simple_table_size=8, each_cuckoo_table_size=6,
                n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                max_items_per_position=3)
    base.update(over)
    return HashTableParams(**base)


@pytest.mark.parametrize("precomp", [False, True])
def test_port_elgamal_run_in_process(capsys, precomp):
    client, server, ok = run_in_process(elgamal_params(precomp=precomp), elgamal_ht(),
                                        device="cpu")
    assert ok and "Set matches!" in capsys.readouterr().out
    assert len(client.intersection_calculated) == 2
    assert client.protocol_name == ("Precomp" if precomp else "Simple") + "P-192"
    assert server.enc.group._native is not None
    assert set(client.measurements) == {"Setup", "Offline", "Online"}
    assert server.online_computation_us > 0 and server.offline_computation_us > 0


@pytest.mark.parametrize("precomp", [False, True])
def test_port_elgamal_with_stash(precomp):
    client, server, ok = run_in_process(elgamal_params(precomp=precomp),
                                        elgamal_ht(server_stash_size=2), device="cpu")
    assert ok and len(client.intersection_calculated) == 2
    assert client.result_size == 3 * 2 + 2


@pytest.mark.parametrize("precomp", [False, True])
@pytest.mark.parametrize(
    "simple_multi,cuckoo_multi", [(False, True), (True, False), (False, False)],
    ids=["combined-simple", "combined-cuckoo", "combined-both"])
def test_port_elgamal_combined_tables(precomp, simple_multi, cuckoo_multi):
    """-s / -c / -s -c: one combined table shared by all hash functions."""
    client, _, ok = run_in_process(
        elgamal_params(precomp=precomp),
        elgamal_ht(simple_multi_table=simple_multi, cuckoo_multi_table=cuckoo_multi,
                   each_cuckoo_table_size=12 if not cuckoo_multi else 6,
                   each_simple_table_size=16 if not simple_multi else 8),
        device="cpu")
    assert ok and len(client.intersection_calculated) == 2


@pytest.mark.parametrize("precomp", [False, True])
def test_port_elgamal_nthreads(precomp):
    """--nThreads 2: the PIEs run on a worker pool; the client verifies and
    the server's compute time is the sum over its jobs."""
    client, server, ok = run_in_process(
        elgamal_params(precomp=precomp, number_of_threads=2), elgamal_ht(), device="cpu")
    assert ok and len(client.intersection_calculated) == 2
    assert len(server.pies) == server.n_pies == 16 and server.online_computation_us > 0


def _mixed(client_cls, server_cls, psi, ht, client_kw, server_kw, data_cls):
    """One client/server pair over a serializing loopback channel."""
    def data():
        return data_cls(psi.server_set_size, psi.client_set_size,
                        psi.intersection_set_size, psi.item_seed, psi.bit_size)

    ch_c, ch_s = JLoop.pair(pass_device_arrays=False)
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


MIXED = {
    "simple_P-192": ("SimpleElGamal", "P-192"),
    "precomp_P-192": ("PrecompElGamal", "P-192"),
}


@pytest.mark.parametrize("case", sorted(MIXED))
@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_mixed_jax_and_port_elgamal(capsys, direction, case):
    name, curve = MIXED[case]
    _mixed_run(capsys, direction, name, elgamal_params(curve_name=curve), elgamal_ht())


def test_mixed_jax_client_port_server_k163(capsys):
    """SimpleElGamal on the binary curve K-163 (the JAX client on its
    pure-Python GF(2^m) law, the port's server on the PCLMUL library)."""
    _mixed_run(capsys, "jax_client_port_server", "SimpleElGamal",
               elgamal_params(curve_name="K-163", server_set_size=30, client_set_size=2,
                              intersection_set_size=1),
               elgamal_ht(each_simple_table_size=4, each_cuckoo_table_size=4))


def _mixed_run(capsys, direction, name, psi, ht):
    prefix = "Precomp" if name == "PrecompElGamal" else "Simple"
    j_pair = (getattr(j_proto, f"{prefix}ElGamalPSIClient"),
              getattr(j_proto, f"{prefix}ElGamalPSIServer"))
    t_pair = (getattr(t_proto, f"{prefix}ElGamalPSIClient"),
              getattr(t_proto, f"{prefix}ElGamalPSIServer"))
    cpu = {"device": "cpu"}
    if direction == "jax_client_port_server":
        args = (j_pair[0], t_pair[1], psi, ht, {}, cpu, JData)
        want_native = (None, True)
    else:
        args = (t_pair[0], j_pair[1], psi, ht, cpu, {}, RandomDataInput)
        want_native = (True, None)
    client, server, ok = _mixed(*args)
    assert ok and "Set matches!" in capsys.readouterr().out
    got_native = tuple(None if p.enc.group._native is None else True for p in (client, server))
    assert got_native == want_native
    jpsi = JPSI(**dataclasses.asdict(psi))
    j_client, _, j_ok = j_run(jpsi, JHT(**dataclasses.asdict(ht)), protocol=name)
    assert j_ok
    assert sorted(map(tuple, client.intersection_calculated)) == \
        sorted(map(tuple, j_client.intersection_calculated))
    assert len(client.intersection_calculated) == psi.intersection_set_size


def test_wire_frame_checks_equal_jax():
    """A ciphertext batch of the wrong length raises the WireFormatError of
    the port's channel, as the JAX party raises its own."""
    from nested_hashing_psi_tpu_torch.protocol.channel import WireFormatError

    psi, ht = elgamal_params(), elgamal_ht()
    ch_a, ch_b = LoopbackChannel.pair()
    server = t_proto.SimpleElGamalPSIServer(
        RandomDataInput(60, 4, 2, psi.item_seed, 16), psi, ht, ch_a, device="cpu")
    server.enc = t_eg.AddHomElGamal(t_ec.ec_group("P-192"))
    ch_b.write_msg(b"\x00" * (2 * 25 * 3 + 1))
    with pytest.raises(WireFormatError, match="expected 3 x 50"):
        server._recv_cts(3)


def test_elgamal_flags_parse_as_in_jax():
    """-P, --curve and --nThreads (and -s, -c, --stash) give the JAX
    config's PSIParams and HashTableParams."""
    argv = ["-P", "--curve", "K-163", "--nThreads", "3", "-s", "-c", "--stash", "2",
            "-B", "128", "-S", "1000", "-C", "32", "-I", "16"]
    t = t_config.params_from_args(t_config.build_arg_parser().parse_args(argv))
    j = j_config.params_from_args(j_config.build_arg_parser().parse_args(argv))
    assert [dataclasses.asdict(x) for x in t] == [dataclasses.asdict(x) for x in j]
    psi, ht = t
    assert (psi.precomp, psi.curve_name, psi.number_of_threads, psi.fhe) == \
        (True, "K-163", 3, False)
    assert (ht.simple_multi_table, ht.cuckoo_multi_table, ht.server_stash_size) == \
        (False, False, 2)


@pytest.mark.parametrize("extra", [[], ["-P"]], ids=["SimpleElGamal", "PrecompElGamal"])
def test_cli_two_processes_elgamal(extra):
    """`python -m nested_hashing_psi_tpu_torch server|client` with no -F (the
    default, SimpleElGamal) and with -P, --device cpu, over localhost TCP.
    Each party names the EC group law it ran: the native library here."""
    flags = ["-B", "16", "-S", "60", "-C", "4", "-I", "2", "-e", "8", "-E", "6", "-b", "3",
             "--curve", "P-192", "--port", str(_free_port()), "--device", "cpu", *extra]
    cmd = [sys.executable, "-m", "nested_hashing_psi_tpu_torch"]
    server = subprocess.Popen(cmd + ["server"] + flags, cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        client = subprocess.run(cmd + ["client"] + flags, cwd=REPO, capture_output=True,
                                text=True, timeout=300)
        assert client.returncode == 0, client.stdout + client.stderr
        assert "Set matches!" in client.stdout
        assert "EC group law: native (P-192)" in client.stdout
        server_out = server.communicate(timeout=60)[0]
        assert server.returncode == 0, server_out
        assert "EC group law: native (P-192)" in server_out
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
