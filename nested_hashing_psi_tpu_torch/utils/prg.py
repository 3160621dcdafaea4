"""Seeded pseudo-random generators.

The port's own copy of ``nested_hashing_psi_tpu.utils.prg``, with the same
names and stream: the port imports nothing of the JAX package, and it does
not need the ``cryptography`` package either. The reference's Precomp
protocol uses an AES-CTR PRG (libscapi PrgFromOpenSSLAES,
reference src/Client/ElGamal/PrecompElGamalPSIClient.cpp:22-24) whose stream
the client regenerates by re-seeding. Here:

 - AesCtrPrg: the AES-128-CTR keystream (counter block 0, a 128-bit
   big-endian counter), computed by ``aes128_encrypt_blocks`` in numpy,
   every block of a request at once; byte-for-byte the stream of the JAX
   package's ``AesCtrPrg``. The stream is small (the Precomp client's bit
   matrix, n_pos x H x E bits), so numpy's speed is enough.
 - The hashing/data layers use numpy Philox streams instead.
"""

from __future__ import annotations

import numpy as np


def _sbox() -> np.ndarray:
    """FIPS-197 S-box: the inverse in GF(2^8) (0 -> 0), then the affine map."""
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):  # 3 generates GF(2^8)^*
        exp[i], log[x] = x, i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
    box = np.zeros(256, np.uint8)
    for v in range(256):
        b = 0 if v == 0 else exp[(255 - log[v]) % 255]
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        box[v] = s ^ 0x63
    return box


_SBOX = _sbox()
_XTIME = np.array([((v << 1) ^ (0x1B if v & 0x80 else 0)) & 0xFF for v in range(256)],
                  np.uint8)
# ShiftRows on the column-major state (byte 4c + r is row r, column c):
# row r moves left by r columns
_SHIFT = np.array([4 * ((c + r) % 4) + r for c in range(4) for r in range(4)])


def _expand_key(key: bytes) -> np.ndarray:
    """The eleven 16-byte round keys of AES-128."""
    words = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        w = list(words[i - 1])
        if i % 4 == 0:
            w = [int(_SBOX[b]) for b in w[1:] + w[:1]]
            w[0] ^= rcon
            rcon = int(_XTIME[rcon])
        words.append([a ^ b for a, b in zip(words[i - 4], w)])
    return np.array(words, np.uint8).reshape(11, 16)


def aes128_encrypt_blocks(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """AES-128 of each row of ``blocks`` ((n, 16) uint8) under ``key``."""
    rk = _expand_key(key)
    s = blocks ^ rk[0]
    for rnd in range(1, 11):
        s = _SBOX[s][:, _SHIFT]
        if rnd < 10:  # MixColumns
            c = s.reshape(-1, 4, 4)
            t = c[:, :, 0] ^ c[:, :, 1] ^ c[:, :, 2] ^ c[:, :, 3]
            s = (c ^ t[:, :, None] ^ _XTIME[c ^ np.roll(c, -1, axis=2)]).reshape(-1, 16)
        s = s ^ rk[rnd]
    return s


def aes128_ctr_keystream(key: bytes, counter0: bytes, first_block: int,
                         n_blocks: int) -> bytes:
    """Blocks [first_block, first_block + n_blocks) of the CTR keystream whose
    counter starts at ``counter0`` and counts as a 128-bit big-endian
    integer (NIST SP 800-38A; the ``cryptography`` package's CTR mode)."""
    start = int.from_bytes(counter0, "big") + first_block
    ctr = np.array([(start + i) % (1 << 128) for i in range(n_blocks)], dtype=object)
    blocks = np.zeros((n_blocks, 16), np.uint8)
    for j in range(16):
        blocks[:, 15 - j] = (ctr >> (8 * j)) & 0xFF
    return aes128_encrypt_blocks(key, blocks).tobytes()


class AesCtrPrg:
    def __init__(self, key: bytes):
        assert len(key) == 16, "fixed 128-bit key (reference parity)"
        self._key = bytes(key)
        self.reset()

    def reset(self) -> None:
        """Re-seed: restart the keystream (the reference's prg.setKey reset)."""
        self._pos = 0

    def get_bytes(self, count: int) -> bytes:
        first, end = self._pos // 16, -(-(self._pos + count) // 16)
        stream = aes128_ctr_keystream(self._key, bytes(16), first, end - first)
        out = stream[self._pos - 16 * first: self._pos - 16 * first + count]
        self._pos += count
        return out

    def get_bits(self, count: int) -> np.ndarray:
        """count 0/1 values, LSB-first per byte (dynamic_bitset layout)."""
        raw = np.frombuffer(self.get_bytes((count + 7) // 8), dtype=np.uint8)
        bits = np.unpackbits(raw, bitorder="little")
        return bits[:count]
