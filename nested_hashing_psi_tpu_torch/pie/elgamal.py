"""ElGamal PIE engines (host-side).

The port's own copy of ``nested_hashing_psi_tpu.pie.elgamal``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_elgamal.py holds it against the original.

Capability parity with the reference's ElGamalPIE and PrecompElGamalPIE
(reference src/Common/Crypto/PrivateIndexedEqualityCheck/ElGamalPIE.cpp,
PrecompElGamalPIE.cpp): per (inner hash fn, bin) the server computes a
randomized encrypted equality between the client's indexed selection of the
bin and the client's element; results are written through a per-PIE output
permutation (hides which hash/bin matched); the stash is handled with plain
randomized equality. The Precomp variant moves all exponentiations offline:
the client's *random* encrypted bit matrix is exponentiated by the table
items (and xor-complemented) up front, so the online step is only additions
selected by the client's plain xor-correction bits.
"""

from __future__ import annotations

import secrets

import numpy as np

from nested_hashing_psi_tpu_torch.crypto.elgamal import AddHomElGamal, ElGamalCiphertext


class ElGamalPIE:
    """One inner cuckoo table's equality engine (reference ElGamalPIE)."""

    def __init__(
        self,
        enc: AddHomElGamal,
        table_values: np.ndarray,  # (n_tables, bins, positions) object/int
        stash_values: list[int],
        multi_table: bool,
        n_hash_functions: int,
        precalc_random: bool = False,
        rng=None,
    ):
        self.enc = enc
        self.H = n_hash_functions
        self.multi_table = multi_table
        self.table = [
            [[int(v) for v in row] for row in tbl] for tbl in table_values
        ]
        self.stash = [int(v) for v in stash_values]
        self.bins = len(self.table[0])
        self.n_results = self.bins * self.H + len(self.stash)
        self._rand = rng or secrets.SystemRandom()
        self.perm = list(range(self.n_results))
        self._rand.shuffle(self.perm)
        self.enc_zeros = enc.encrypt_zero_batch(self.n_results)
        self.precalc_random = precalc_random
        if precalc_random:
            if not multi_table:
                raise ValueError("precalc randomness needs multi tables")
            q = enc.group.order
            self.randomness = [
                [self._rand.randrange(1, q) for _ in range(self.bins)]
                for _ in range(self.H)
            ]
            for h in range(self.H):
                for b in range(self.bins):
                    r = self.randomness[h][b]
                    self.table[h][b] = [v * r % q for v in self.table[h][b]]

        self.index_matrix: list[list[ElGamalCiphertext]] | None = None
        self.minus_elem: ElGamalCiphertext | None = None

    def _tbl(self, h: int) -> int:
        return h if self.multi_table else 0

    def run(self) -> list[ElGamalCiphertext]:
        results: list[ElGamalCiphertext | None] = [None] * self.n_results
        if self.enc._has_batch():
            self._run_batched(results)
        else:
            self._run_scalar(results)
        ri = self.bins * self.H
        for s in self.stash:
            results[self.perm[ri]] = self.enc.randomized_equality(
                self.minus_elem, s, self.enc_zeros[ri]
            )
            ri += 1
        return results

    def _run_scalar(self, results) -> None:
        ri = 0
        for h in range(self.H):
            for b in range(self.bins):
                if self.precalc_random:
                    res = self.enc.custom_indexed_randomized_equality(
                        self.index_matrix[h],
                        self.table[self._tbl(h)][b],
                        self.minus_elem,
                        self.enc_zeros[ri],
                        self.randomness[h][b],
                    )
                else:
                    res = self.enc.indexed_randomized_equality(
                        self.index_matrix[h],
                        self.table[self._tbl(h)][b],
                        self.minus_elem,
                        self.enc_zeros[ri],
                    )
                results[self.perm[ri]] = res
                ri += 1

    def _run_batched(self, results) -> None:
        """All (hash fn, bin) equality checks through the native batch
        entry points: H*B grouped multi-exponentiations per ciphertext
        component, then one batched randomized-equality pass (or, on the
        precalc path, the fused multi-exp including mask and Enc(0))."""
        g = self.enc.group
        n = self.H * self.bins
        if self.precalc_random:
            pts1, pts2, scalars = [], [], []
            ri = 0
            for h in range(self.H):
                idx = self.index_matrix[h]
                for b in range(self.bins):
                    cts = list(idx) + [self.minus_elem, self.enc_zeros[ri]]
                    pts1 += [c.c1 for c in cts]
                    pts2 += [c.c2 for c in cts]
                    scalars += list(self.table[self._tbl(h)][b]) + [
                        self.randomness[h][b], 1,
                    ]
                    ri += 1
            k = len(self.index_matrix[0]) + 2
            out1 = g.multi_mul_groups(pts1, scalars, n, k)
            out2 = g.multi_mul_groups(pts2, scalars, n, k)
            for ri in range(n):
                results[self.perm[ri]] = ElGamalCiphertext(out1[ri], out2[ri])
            return
        pts1, pts2, scalars = [], [], []
        for h in range(self.H):
            idx = self.index_matrix[h]
            for b in range(self.bins):
                pts1 += [c.c1 for c in idx]
                pts2 += [c.c2 for c in idx]
                scalars += list(self.table[self._tbl(h)][b])
        k = len(self.index_matrix[0])
        ip1 = g.multi_mul_groups(pts1, scalars, n, k)
        ip2 = g.multi_mul_groups(pts2, scalars, n, k)
        ips = [ElGamalCiphertext(a, b) for a, b in zip(ip1, ip2)]
        res = self.enc.randomized_equality_batch(
            self.minus_elem, ips, self.enc_zeros[:n]
        )
        for ri in range(n):
            results[self.perm[ri]] = res[ri]


class PrecompElGamalPIE:
    """Precomputation variant (reference PrecompElGamalPIE)."""

    def __init__(
        self,
        enc: AddHomElGamal,
        table_values: np.ndarray,
        stash_values: list[int],
        multi_table: bool,
        n_hash_functions: int,
        rng=None,
    ):
        self.enc = enc
        self.H = n_hash_functions
        self.multi_table = multi_table
        self.table = [
            [[int(v) for v in row] for row in tbl] for tbl in table_values
        ]
        self.stash = [int(v) for v in stash_values]
        self.bins = len(self.table[0])
        self.positions = len(self.table[0][0])
        self.n_results = self.bins * self.H + len(self.stash)
        self._rand = rng or secrets.SystemRandom()
        self.perm = list(range(self.n_results))
        self._rand.shuffle(self.perm)
        self.enc_zeros = enc.encrypt_zero_batch(self.n_results)
        self.index_matrix: list[list[ElGamalCiphertext]] | None = None
        self.minus_elem: ElGamalCiphertext | None = None

    def _tbl(self, h: int) -> int:
        return h if self.multi_table else 0

    def precomp(self) -> None:
        """Offline: Enc(b_j)^item and its xor-complement per (hf, bin, pos)
        (PrecompElGamalPIE.cpp:31-55)."""
        if self.index_matrix is None:
            raise RuntimeError("index matrix not set before precomp")
        self.enc_matrix = []
        self.neg_matrix = []
        for h in range(self.H):
            em = [[None] * self.positions for _ in range(self.bins)]
            nm = [[None] * self.positions for _ in range(self.bins)]
            for j in range(self.positions):
                # one window table per index ciphertext, amortized over all
                # bin exponents (reference exponentiateWithPreComputedValues)
                items = [self.table[self._tbl(h)][b][j] for b in range(self.bins)]
                cts = self.enc.mult_by_const_many(self.index_matrix[h][j], items)
                if self.enc._has_batch():
                    # xor-complements via batched g^item and pair sums
                    g = self.enc.group
                    gitems = g.mul_gen_batch(items)
                    neg2 = [g.neg(c.c2) for c in cts]
                    pairs = [pt for ab in zip(neg2, gitems) for pt in ab]
                    sums = g.sum_groups(pairs, self.bins, 2)
                    for b in range(self.bins):
                        em[b][j] = cts[b]
                        nm[b][j] = ElGamalCiphertext(g.neg(cts[b].c1), sums[b])
                else:
                    for b in range(self.bins):
                        em[b][j] = cts[b]
                        nm[b][j] = self.enc.element_xor_by_const(cts[b], items[b])
            self.enc_matrix.append(em)
            self.neg_matrix.append(nm)

    def run(self, xor_bits: np.ndarray) -> list[ElGamalCiphertext]:
        """Online: per bin, sum the client-selected precomputed ciphertexts,
        then randomized equality. xor_bits: (H * positions,) 0/1."""
        results: list[ElGamalCiphertext | None] = [None] * self.n_results
        ri = 0
        if self.enc._has_batch():
            # one native call sums every bin's selected ciphertexts; one
            # batched randomized-equality pass masks them
            g = self.enc.group
            n = self.H * self.bins
            c1s, c2s = [], []
            for h in range(self.H):
                bits = xor_bits[h * self.positions : (h + 1) * self.positions]
                for b in range(self.bins):
                    for j in range(self.positions):
                        src = self.neg_matrix if bits[j] else self.enc_matrix
                        ct = src[h][b][j]
                        c1s.append(ct.c1)
                        c2s.append(ct.c2)
            acc1 = g.sum_groups(c1s, n, self.positions)
            acc2 = g.sum_groups(c2s, n, self.positions)
            accs = [ElGamalCiphertext(a, b) for a, b in zip(acc1, acc2)]
            res = self.enc.randomized_equality_batch(
                self.minus_elem, accs, self.enc_zeros[:n]
            )
            for ri in range(n):
                results[self.perm[ri]] = res[ri]
            ri = n
        else:
            for h in range(self.H):
                bits = xor_bits[h * self.positions : (h + 1) * self.positions]
                for b in range(self.bins):
                    acc = None
                    for j in range(self.positions):
                        src = self.neg_matrix if bits[j] else self.enc_matrix
                        ct = src[h][b][j]
                        acc = ct if acc is None else self.enc.add(acc, ct)
                    results[self.perm[ri]] = self.enc.randomized_equality(
                        self.minus_elem, acc, self.enc_zeros[ri]
                    )
                    ri += 1
        for s in self.stash:
            results[self.perm[ri]] = self.enc.randomized_equality(
                self.minus_elem, s, self.enc_zeros[ri]
            )
            ri += 1
        return results
