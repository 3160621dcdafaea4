"""FHE parameter generation.

A verbatim copy of ``nested_hashing_psi_tpu.fhe.params`` (that module loads
jax through its package ``__init__``); tests/test_torch_host_copies.py pins
the two equal. It reproduces the reference's parameter policy
(BatchedFHEPSIClient.cpp:22-79):
 - plaintext modulus by item bit size: {16: 2^16+1, 32: 2^32+2^20+2^19+1,
   40: 2^40+2^22+2^20+1, 48: 2^48+2^22+2^20+1} (all NTT-friendly: 2n | t-1
   for n = 16384),
 - ring dimension 16384,
 - multiplicative depth by inner cuckoo table size {<500: 3, <5000: 5,
   else: 10},
 - 128-bit classical security: total log2(q) <= 438 at n = 16384
   (HEStd_128_classic table).

Divergence from OpenFHE (~60-bit RNS limbs): q is built from <=31-bit
NTT-friendly primes (q_i = 1 mod 2n), so every residue fits a 32-bit lane --
about twice the limb count for the same modulus size, each limb twice as
cheap. Both packages share this choice, which keeps their residues bit-equal.
"""

from __future__ import annotations

from dataclasses import dataclass

from nested_hashing_psi_tpu_torch.ops import primes as primes_mod

PLAINTEXT_MODULI = {
    16: 65537,
    32: (1 << 32) + (1 << 20) + (1 << 19) + 1,
    40: (1 << 40) + (1 << 22) + (1 << 20) + 1,
    48: (1 << 48) + (1 << 22) + (1 << 20) + 1,
}

# HEStd_128_classic max log2(q) for power-of-two ring dims (ternary secret).
MAX_LOG_Q_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881}

LIMB_BITS = 31


def plaintext_modulus_for_bit_size(bit_size: int) -> int:
    if bit_size not in PLAINTEXT_MODULI:
        raise ValueError("FHE supports bit sizes 16, 32, 40 or 48")
    return PLAINTEXT_MODULI[bit_size]


def leveled_default(scheme: str, t: int, n_cuckoo_hash_functions: int) -> bool:
    """Whether the batched PIE should run leveled (BGV mod-switch chain):
    BGV with device-arithmetic-sized t and at least one ct x ct mult.
    BFV uses HPS multiplication (additive noise) and never switches."""
    return scheme == "bgv" and t < 2**31 and n_cuckoo_hash_functions > 1


def depth_for_cuckoo_table_size(each_cuckoo_table_size: int) -> int:
    """Reference depth schedule (BatchedFHEPSIClient.cpp:44-57)."""
    if each_cuckoo_table_size < 500:
        return 3
    if each_cuckoo_table_size < 5000:
        return 5
    return 10


def default_num_limbs(
    t_bits: int,
    n_ct_mults: int,
    sum_len: int,
    scheme: str = "bgv",
    leveled: bool = False,
    eval_sum: bool = False,
    ring_dim: int = 16384,
) -> int:
    """Worst-case-ish noise budget -> number of 31-bit limbs.

    n_ct_mults: sequential ct x ct multiplications (nCuckooHF - 1 in the
    batched PIE). sum_len: length of the ct x pt inner-product accumulation.

    Models (validated empirically by tests/test_bgv.py and
    tests/test_leveled_pie.py noise checks):
     - BGV, flat: noise multiplies per ct x ct; budget the full product.
     - BGV, leveled: the PIE drops one limb per multiplication (the
       reference's MultiplicativeDepth schedule, BatchedFHEPSIClient.cpp:44-57);
       each switch divides noise by ~2^31 down to the switching floor, so
       the total is a small base + one limb per level.
     - BFV (HPS multiplication, fhe.bfv): noise grows *additively*
       (~ +t_bits+logn per multiplication), no switching needed.
    """
    import math

    logn = ring_dim.bit_length() - 1
    fresh = t_bits + 6
    ip = fresh + t_bits + logn + max(1, sum_len).bit_length()
    mults = max(0, n_ct_mults)

    if scheme == "bfv":
        acc = ip
        if eval_sum:
            # EvalSum slot ladder (SimpleFHE PIE): the slot sum multiplies
            # noise by ~n and adds ~logn gadget key switches (empirically
            # ~LIMB_BITS + t_bits + 3*logn over the fresh ct x pt noise)
            acc = max(acc, LIMB_BITS + t_bits + 3 * logn + fresh)
        for _ in range(mults):
            acc = acc + t_bits + logn + 2
        mask = acc + t_bits + logn
        margin = 25
        return max(2, math.ceil((mask + margin) / LIMB_BITS))

    if eval_sum:
        # EvalSum slot ladder in BGV: key-switch noise is additionally
        # amplified by t (the gadget error enters as t*e), so the BFV
        # empirical model gains one more t_bits term.
        ip = max(ip, LIMB_BITS + 2 * t_bits + 3 * logn + fresh)

    if leveled and mults > 0:
        floor = t_bits + 12  # mod-switch rounding floor ~ t * small
        acc = max(ip - LIMB_BITS, floor)
        for h in range(1, mults + 1):
            op = max(ip - h * LIMB_BITS, floor)
            acc = acc + op + logn
            if h < mults:
                acc = max(acc - LIMB_BITS, floor)
        mask = acc + t_bits + logn
        margin = 25
        base = max(2, math.ceil((mask + margin) / LIMB_BITS))
        return base + mults

    acc = ip
    for _ in range(mults):
        acc = acc + ip + logn
    mask = acc + t_bits + logn
    margin = 25
    return max(2, math.ceil((mask + margin) / LIMB_BITS))


def bfv_mul_limbs(
    t_bits: int, num_limbs: int, n_ct_mults: int = 1, ring_dim: int = 16384
) -> int:
    """Mult-basis limb count for the *rescaled* BFV PIE pipeline.

    The batched PIE applies the per-depth mask BEFORE the cross-hash
    multiplication chain (mask * ip_0 * ... * ip_{H-1} -- the same product,
    reassociated), so after rescaling the operands down to this basis the
    only remaining noise growth is the HPS multiplications themselves:

      post-rescale floor ~ t * small   (delta*m + centered s-rounding)
      each HPS mult      + t_bits + logn + 2
      decrypt            noise < Delta'/2 = q_mul / (2t)

    Worst-case model with a 20-bit margin; validated empirically by
    tests/test_bfv_rescale.py noise checks.
    """
    import math

    logn = ring_dim.bit_length() - 1
    floor_noise = t_bits + logn - 1  # t * (rounding small): ~sqrt(n)-scaled
    need = (
        floor_noise
        + max(1, n_ct_mults) * (t_bits + logn + 2)
        + t_bits
        + 1
        + 20
    )
    return max(2, min(num_limbs, math.ceil(need / 31)))


def bfv_batched_client_limbs(
    t_bits: int, sum_len: int, n_cuckoo_hash_functions: int,
    ring_dim: int = 16384,
) -> int:
    """Client/context limb count for the batched-BFV protocol running the
    rescaled pipeline with folded masks (pie.batched_fhe.combine_ip).

    With the masks folded into the table, the full basis only ever carries
    the position-sum noise (fresh pk encrypt * t-sized table values * n,
    summed over the inner positions); the mult chain runs on the rescaled
    basis with floored operands. So L = max of
      - one limb above the mult basis (the rescale must drop >= 1 limb to
        floor the operands),
      - the position-sum stage's own budget.
    At 32-bit t this gives 6 limbs (was 7 under the mask-at-the-end model);
    empirical margin test: tests/test_bfv_rescale.py ring-16384 L=6.
    """
    import math

    logn = ring_dim.bit_length() - 1
    mul = bfv_mul_limbs(
        t_bits, 99, max(1, n_cuckoo_hash_functions - 1), ring_dim=ring_dim
    )
    ip = 21 + t_bits + logn + max(1, sum_len).bit_length()
    stage = math.ceil((ip + t_bits + 1 + 20) / 31)
    return max(mul + 1, stage, 2)


def bfv_ship_limbs(t_bits: int, mul_limbs: int, ring_dim: int = 16384) -> int:
    """Shipped-result limb count: one more rescale after the final
    multiplication drops the result to the smallest basis whose decrypt
    budget still clears the post-rescale floor (same model as above)."""
    import math

    logn = ring_dim.bit_length() - 1
    floor_noise = t_bits + logn - 1
    need = floor_noise + t_bits + 1 + 20
    return max(2, min(mul_limbs, math.ceil(need / 31)))


@dataclass(frozen=True)
class SchemeParams:
    """Parameters for one BGV/BFV context instance."""

    ring_dim: int = 16384
    plaintext_modulus: int = 65537
    num_limbs: int = 8
    error_std: float = 3.2
    scheme: str = "bgv"

    @property
    def q_primes(self) -> tuple[int, ...]:
        ps = primes_mod.ntt_primes(
            self.num_limbs, LIMB_BITS, 2 * self.ring_dim,
            avoid=(self.plaintext_modulus,),
        )
        return ps

    @property
    def q(self) -> int:
        out = 1
        for p in self.q_primes:
            out *= p
        return out

    def validate_security(self, allow_insecure: bool = False) -> None:
        """Enforce the HEStd_128_classic log2(q) bound for every tabled ring
        dimension (1024..32768). allow_insecure is the explicit escape for
        small-ring tests; production paths never set it."""
        if allow_insecure:
            return
        max_bits = MAX_LOG_Q_128.get(self.ring_dim)
        if max_bits is not None and self.q.bit_length() > max_bits:
            raise ValueError(
                f"log2(q) = {self.q.bit_length()} exceeds the 128-bit classical "
                f"bound {max_bits} for ring dim {self.ring_dim}"
            )

    @classmethod
    def for_psi(
        cls,
        bit_size: int,
        each_cuckoo_table_size: int,
        n_cuckoo_hash_functions: int,
        ring_dim: int = 16384,
        scheme: str = "bgv",
    ) -> "SchemeParams":
        t = plaintext_modulus_for_bit_size(bit_size)
        limbs = default_num_limbs(
            t.bit_length(), n_cuckoo_hash_functions - 1, each_cuckoo_table_size
        )
        p = cls(
            ring_dim=ring_dim,
            plaintext_modulus=t,
            num_limbs=limbs,
            scheme=scheme,
        )
        p.validate_security()
        return p


# Ring dimensions the framework supports end-to-end (power-of-two negacyclic
# NTT plans; the HEStd table covers 1024..32768, smaller dims are test-only).
SUPPORTED_RING_DIMS = frozenset(
    1 << k for k in range(4, 16)
)
MAX_WIRE_LIMBS = 32  # ceiling on peer-requested limb counts (resource bound)


def validate_wire_scheme_params(
    ring_dim: int, t: int, num_limbs: int, scheme: str
) -> SchemeParams:
    """Sanity-validate peer-supplied scheme parameters BEFORE constructing a
    context from them (a hostile client could otherwise demand absurd limb
    counts or ring dims -- a resource-exhaustion vector the reference avoids
    because OpenFHE validates its deserialized contexts). Returns the
    validated SchemeParams; raises ValueError on any violation, including
    the HEStd_128 bound for tabled ring dims."""
    if scheme not in ("bgv", "bfv"):
        raise ValueError(f"unknown scheme {scheme!r} from peer")
    if ring_dim not in SUPPORTED_RING_DIMS:
        raise ValueError(f"unsupported ring dimension {ring_dim} from peer")
    if not (1 <= num_limbs <= MAX_WIRE_LIMBS):
        raise ValueError(
            f"limb count {num_limbs} outside [1, {MAX_WIRE_LIMBS}]"
        )
    if not (2 <= t < 1 << 50):
        raise ValueError(f"plaintext modulus {t} outside supported range")
    if (t - 1) % (2 * ring_dim) != 0:
        raise ValueError(
            f"plaintext modulus {t} is not NTT-friendly for ring {ring_dim}"
        )
    sp = SchemeParams(
        ring_dim=ring_dim,
        plaintext_modulus=t,
        num_limbs=num_limbs,
        scheme=scheme,
    )
    sp.validate_security()
    return sp
