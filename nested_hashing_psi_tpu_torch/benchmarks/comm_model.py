"""Bytes each rank sends per query under each sharding of the online step.

Counterpart of ``benchmarks/comm_model.py``, on the port's own step
implementations (``parallel/mesh.py``, ``parallel/dist_ntt.py``), whose
counts the CPU tests pin (``tests/test_torch_parallel.py``,
``tests/test_torch_ntt4.py``):

  dp x tp  the position sums and minus are gathered over tp once per
           query; the masks and relin key only on the first query:
               (H (D/dp) 2 + 2) (L/tp) N 4 (tp - 1)
  sp       the ring axis over S ranks; every limb transform of the flat
           full-basis product and its relinearisation is a ring-exchange
           NTT of log2(S) block swaps of N/S residues:
               T (N/S) 4 log2(S),  T = D (H - 1) (11 L + 7 KA + L^2) (BFV,
               KA aux primes) or D (H - 1) (L + L^2) (BGV)
  pp       positions over a ring of k ranks; the running sums of the
           depth chunks travel k - 1 hops:
               (k - 1) H (D/k) 2 L N 4

With ``--t1-ms`` (a measured one-card ms per query) each row also gets a
modelled time t1/ranks + bytes / link rate, overlap ignored; the link rate
(``--link-GBps``) has no default: the card's NVLink rate between ranks is
not measured here.

    python -m nested_hashing_psi_tpu_torch.benchmarks.comm_model --link-GBps R [--t1-ms T]
"""

from __future__ import annotations

import argparse
import json

from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams, bfv_batched_client_limbs
from nested_hashing_psi_tpu_torch.ops.basis import BFVMulConverter

T32 = (1 << 32) + (1 << 20) + (1 << 19) + 1
STRATEGIES = (("dp x tp", 2, 2), ("dp x tp", 4, 2), ("sp", 8, 1), ("pp", 8, 1),
              ("dp x tp", 8, 2))


def aux_limbs(L: int, t: int = T32, n: int = 16384) -> int:
    """KA: the HPS aux base's primes for a BFV context of L limbs."""
    q = SchemeParams(ring_dim=n, plaintext_modulus=t, num_limbs=L, scheme="bfv").q_primes
    return len(BFVMulConverter(q, t, n).aux_primes)


def sp_transforms(H: int, D: int, L: int, scheme: str = "bfv", KA: int = 0) -> int:
    """Limb transforms of one query of the ring-sharded step (flat product)."""
    per = 11 * L + 7 * KA + L * L if scheme == "bfv" else L + L * L
    return D * (H - 1) * per


def dp_tp_bytes(H: int, D: int, L: int, N: int, dp: int, tp: int) -> int:
    return (H * (D // dp) * 2 + 2) * (L // tp) * N * 4 * (tp - 1)


def sp_bytes(transforms: int, N: int, S: int) -> int:
    return transforms * (N // S) * 4 * (S.bit_length() - 1)


def pp_bytes(H: int, D: int, L: int, N: int, k: int) -> int:
    return (k - 1) * H * (D // k) * 2 * L * N * 4


def splits(kind: str, H: int, D: int, P: int, L: int, N: int, a: int, b: int) -> str | None:
    """Why the step cannot take this layout, or None (the steps' own checks)."""
    if kind == "dp x tp" and (D % a or L % b):
        return f"D = {D} over dp = {a} or L = {L} over tp = {b} does not split"
    if kind == "sp" and (N % a or a & (a - 1)):
        return f"N = {N} over {a} ranks"
    if kind == "pp" and (D % a or P % a):
        return f"D = {D} or P = {P} over k = {a} does not split"
    return None


def model(name: str, H: int, D: int, P: int, L: int, N: int, scheme: str = "bfv",
          t1_ms: float | None = None, link_GBps: float | None = None) -> dict:
    KA = aux_limbs(L, T32, N) if scheme == "bfv" else 0
    T = sp_transforms(H, D, L, scheme, KA)
    rows = []
    for kind, a, b in STRATEGIES:
        ranks = a * b
        row = {"strategy": f"dp{a} x tp{b}" if kind == "dp x tp" else f"{kind}{a}",
               "ranks": ranks}
        why = splits(kind, H, D, P, L, N, a, b)
        if why:
            rows.append({**row, "does_not_split": why})
            continue
        net = (dp_tp_bytes(H, D, L, N, a, b) if kind == "dp x tp"
               else sp_bytes(T, N, a) if kind == "sp" else pp_bytes(H, D, L, N, a))
        row["bytes_per_rank_per_query"] = net
        if t1_ms is not None:
            t_n = t1_ms / ranks + net / (link_GBps * 1e9) * 1e3
            row.update(modeled_ms=t_n, efficiency=t1_ms / (ranks * t_n))
        rows.append(row)
    return {"geometry": name, "scheme": scheme, "H": H, "D": D, "P": P, "L": L, "n": N,
            "aux_limbs": KA, "sp_transforms_per_query": T, "link_GBps": link_GBps,
            "t1_ms": t1_ms, "rows": rows}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--link-GBps", type=float, required=True,
                    help="bytes/s between two ranks, in GB/s (no default: not measured)")
    ap.add_argument("--t1-ms", type=float, default=None,
                    help="a measured one-card ms/query at the 2^20 row")
    ap.add_argument("--t1-ns-ms", type=float, default=None,
                    help="a measured one-card ms/query at the north star")
    a = ap.parse_args(argv)
    L = bfv_batched_client_limbs(T32.bit_length(), 12, 2)
    L_ns = bfv_batched_client_limbs(T32.bit_length(), 48, 2)
    out = [
        model("2^20 x 2048 (Parameters1 row 12)", 2, 12, 12, L, 16384,
              t1_ms=a.t1_ms, link_GBps=a.link_GBps),
        model("north star 2^24 x 2^12", 2, 48, 48, L_ns, 16384,
              t1_ms=a.t1_ns_ms, link_GBps=a.link_GBps),
    ]
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
