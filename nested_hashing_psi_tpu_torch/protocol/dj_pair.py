"""Two-party Damgard-Jurik private equality check over sockets.

The port's own copy of ``nested_hashing_psi_tpu.protocol.dj_pair``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_elgamal.py holds it against the original.

Capability parity with the reference's legacy DJ test mains
(reference tests/TestServerDJ.cpp:14-140, TestClientDJ.cpp:10-100),
which exercise an additively-homomorphic index-select + equality protocol
outside the main PSI track:

  client: generates a DJ keypair, sends the public key, then the encrypted
          one-hot index vector Enc(index == i) and finally Enc(elem)
  server: multByConst each index slot by its set element, adds them up
          (selects Enc(serverSet[index])), subtracts it from Enc(elem) and
          multiplies by a random nonzero obfuscator
  client: decrypts -- 0 iff the server's element at `index` equals `elem`

Wire format: length-prefixed big-endian integers over the framework Channel
(the reference ships libscapi BigIntegerCiphertext byte vectors). Timing
rows (Send Index Vector / Multiplication / Addition) are exported in the
reference's M_S{n}_K{bits}.csv schema when export_path is given.
"""

from __future__ import annotations

import secrets
import time

import numpy as np

from nested_hashing_psi_tpu_torch.crypto.damgard_jurik import DamgardJurik
from nested_hashing_psi_tpu_torch.protocol.channel import Channel

_SET_SEED = 1498165861356  # reference shared PRG seed (TestServerDJ.cpp:38)


def _ibytes(v: int) -> bytes:
    return int(v).to_bytes((int(v).bit_length() + 7) // 8 or 1, "big")


def _server_set(array_size: int) -> list[int]:
    rng = np.random.Generator(np.random.Philox(key=_SET_SEED))
    return [int(v) for v in rng.integers(0, 1 << 63, size=array_size, dtype=np.uint64)]


def run_dj_server(
    channel: Channel, array_size: int, export_path: str | None = None
) -> None:
    """Server side: homomorphic select + randomized difference."""
    server_set = _server_set(array_size)
    n = int.from_bytes(channel.read_msg(), "big")
    dj = DamgardJurik.from_public(n)  # s = 1: the pk is just the modulus
    rows = []
    t0 = time.perf_counter()
    index_cts = [
        int.from_bytes(channel.read_msg(), "big") for _ in range(array_size)
    ]
    rows.append(("Send Index Vector", time.perf_counter() - t0))
    t0 = time.perf_counter()
    mult = [dj.mult_by_const(c, v) for c, v in zip(index_cts, server_set)]
    rows.append(("Multiplication", time.perf_counter() - t0))
    t0 = time.perf_counter()
    acc = mult[0]
    for c in mult[1:]:
        acc = dj.add(acc, c)
    rows.append(("Addition", time.perf_counter() - t0))
    elem_ct = int.from_bytes(channel.read_msg(), "big")
    # Enc(elem - selected), obfuscated by a random nonzero scalar
    diff = dj.add(elem_ct, dj.mult_by_const(acc, dj.n_s - 1))
    r = secrets.randbelow((1 << 64) - 1) + 1
    out = dj.mult_by_const(diff, r)
    channel.write_msg(_ibytes(out))
    if export_path:
        with open(export_path, "w") as f:
            for name, dt in rows:
                f.write(f"{name},{int(dt * 1e6)}\n")


def run_dj_client(
    channel: Channel,
    array_size: int,
    elem_index: int,
    differ: bool,
    modulus_bits: int = 1024,
) -> bool:
    """Client side. Returns True iff the protocol reports equality
    (reference: decrypted value == 0)."""
    server_set = _server_set(array_size)
    elem_index %= array_size
    elem = (
        int(np.random.Generator(np.random.Philox(key=99)).integers(1 << 62))
        if differ
        else server_set[elem_index]
    )
    dj = DamgardJurik(modulus_bits=modulus_bits)
    channel.write_msg(_ibytes(dj.n))
    for i in range(array_size):
        channel.write_msg(_ibytes(dj.encrypt(1 if i == elem_index else 0)))
    channel.write_msg(_ibytes(dj.encrypt(elem)))
    result_ct = int.from_bytes(channel.read_msg(), "big")
    return dj.decrypt(result_ct) == 0
