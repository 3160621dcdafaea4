"""RNS base conversions of the BFV rescaled-mult pipeline (plain PyTorch).

Counterpart of ``nested_hashing_psi_tpu.ops.basis``: ``BasisExtension``
(the HPS fast base conversion from a base q to a disjoint base B),
``RNSRescale`` (the exact drop-limb BFV modulus switch) and
``BFVMulConverter`` (textbook HPS ct x ct: the q -> aux extension, which is
a ``BasisExtension``, t/q scale-and-round, exact Shenoy-Kumaresan aux -> q).
The host constants are the reference's numpy arrays; ``_consts(device)``
lifts them to int64 tensors once per device.

On a CUDA tensor each conversion launches its CUDA kernel (csrc/hps.cu,
``ops.hps_cuda``) or raises; the ``*_plain`` methods are the plain PyTorch
versions, the CPU path and the kernels' oracle.

Float width of the overflow estimates: **float64**. The reference computes
them in float64 only when ``jax_enable_x64`` is set and in float32
otherwise; float64 is the more accurate of the two and costs nothing that
matters on an H100. The estimates only pick a rounding (a miss moves a
value by +-1 or by a multiple of q, which the noise budget absorbs), and the
tests hold the port bit-exact against the reference run under
``jax.enable_x64(True)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.ops import hps_cuda
from nested_hashing_psi_tpu_torch.ops.modmath import (
    add_mod,
    modsum,
    shoup_host,
    shoup_mul,
    sub_mod,
)


def _shoup_pair(vals, ps) -> tuple[np.ndarray, np.ndarray]:
    """(w, floor(w * 2**32 / p)) as uint32 arrays; vals/ps broadcastable."""
    w = np.asarray(vals, np.uint64)
    p = np.asarray(ps, np.uint64)
    wq = (w << np.uint64(32)) // p
    return w.astype(np.uint32), wq.astype(np.uint32)


class _DeviceConsts:
    """Lazily lifts the numpy constants named in ``_CONSTS`` (arrays, or
    Shoup pairs as 2-tuples) to int64/float64 tensors, once per device."""

    _CONSTS: tuple[str, ...] = ()

    def _consts(self, device) -> dict:
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dev_cache", {})
        if device not in cache:
            def lift(a):
                a = np.asarray(a)
                a = a.astype(np.float64 if a.dtype.kind == "f" else np.int64)
                return torch.from_numpy(a).to(device)

            out = {}
            for name in self._CONSTS:
                v = getattr(self, name)
                out[name] = (
                    (lift(v[0]), lift(v[1])) if isinstance(v, tuple) else lift(v)
                )
            cache[device] = out
        return cache[device]


class BasisExtension(_DeviceConsts):
    """Fast base conversion from RNS base ``src`` to disjoint base ``dst``.

    With y_i = [x_i * (q/q_i)^{-1}]_{q_i}, x = sum_i y_i * (q/q_i) - v*q for
    v = round(sum_i y_i / q_i), so [x]_{b_j} = sum_i y_i * [q/q_i]_{b_j} -
    v * [q]_{b_j}. The overflow count v is a float64 estimate: a boundary
    miss leaves the result off by +-q, which HPS's noise analysis absorbs.
    Every multiply has a precomputed constant operand (Shoup form).
    """

    _CONSTS = ("src_p", "dst_p", "qhat_inv", "qhat_mod_b", "q_mod_b", "_inv_src_np")

    def __init__(self, src_primes, dst_primes):
        src = [int(p) for p in src_primes]
        dst = [int(p) for p in dst_primes]
        if set(src) & set(dst):
            raise ValueError("bases must be disjoint")
        self.src_primes, self.dst_primes = tuple(src), tuple(dst)
        L, K = len(src), len(dst)
        q = math.prod(src)
        self.q = q

        src_a = np.array(src, np.uint32).reshape(L, 1)
        dst_a = np.array(dst, np.uint32).reshape(K, 1)
        self.src_p = src_a
        self.dst_p = dst_a
        # [(q/q_i)^{-1}]_{q_i}, shaped (L, 1)
        self.qhat_inv = _shoup_pair(
            np.array([pow(q // p, -1, p) for p in src], np.uint64).reshape(L, 1), src_a
        )
        # [(q/q_i)]_{b_j}, shaped (L, K, 1)
        qhat_mod_b = np.zeros((L, K, 1), np.uint64)
        for i, p in enumerate(src):
            for j, b in enumerate(dst):
                qhat_mod_b[i, j, 0] = (q // p) % b
        self.qhat_mod_b = _shoup_pair(qhat_mod_b, dst_a[None])
        self.q_mod_b = _shoup_pair(
            np.array([q % b for b in dst], np.uint64).reshape(K, 1), dst_a
        )
        self._inv_src_np = np.array([1.0 / p for p in src]).reshape(L, 1)

    def convert(self, x: torch.Tensor, correction: bool = True) -> torch.Tensor:
        """(..., L, N) coefficient-domain residues over src -> (..., K, N)
        over dst. Exact up to a possible +-q boundary miss (correction=True),
        or x + u*q for some u in [0, L) (correction=False, the lazy variant
        that skips the overflow count). A CUDA tensor goes to the HPS
        kernel (``ops.hps_cuda``), bit-exact with ``convert_plain``."""
        if x.is_cuda:
            return hps_cuda.rescale_extend(x.contiguous(), extension=self,
                                           correction=correction)[1]
        return self.convert_plain(x, correction)

    def convert_plain(self, x: torch.Tensor, correction: bool = True) -> torch.Tensor:
        """``convert`` in plain PyTorch, on any device."""
        c = self._consts(x.device)
        dst_p = c["dst_p"]
        y = shoup_mul(x, *c["qhat_inv"], c["src_p"])
        # y_i < 2**31: Shoup needs no cross-prime pre-reduction
        terms = shoup_mul(y[..., :, None, :], *c["qhat_mod_b"], dst_p)
        acc = modsum(terms, dst_p, axis=-3)  # (..., K, N)
        if not correction:
            return acc
        # float64, summed over the limbs as the reference's jnp.sum(axis=-2)
        v = torch.round(torch.sum(y.double() * c["_inv_src_np"], dim=-2)).long()
        vq = shoup_mul(v[..., None, :], *c["q_mod_b"], dst_p)
        return sub_mod(acc, vq, dst_p)


class RNSRescale(_DeviceConsts):
    """Exact RNS drop-limb rescale in coefficient domain (BFV mod switch).

    c' = (c - [c]_{qd})/qd over the kept base, qd = product of the dropped
    trailing primes, [c]_{qd} the *centered* residue, reconstructed CRT-style
    from the dropped limbs with a float overflow count (a boundary miss
    moves c' by +-1 -- one ulp of rounding noise).
    """

    _CONSTS = ("p_keep", "p_drop", "qdhat_inv", "qdhat_mod_k", "qd_mod_k",
               "qdinv_mod_k", "_inv_drop_np")

    def __init__(self, src_primes, n_drop: int):
        src = [int(p) for p in src_primes]
        assert 1 <= n_drop < len(src)
        keep, drop = src[:-n_drop], src[-n_drop:]
        self.keep_primes, self.drop_primes = tuple(keep), tuple(drop)
        Lk, Ld = len(keep), len(drop)
        self.n_drop = n_drop
        qd = math.prod(drop)

        keep_a = np.array(keep, np.uint32).reshape(Lk, 1)
        drop_a = np.array(drop, np.uint32).reshape(Ld, 1)
        self.p_keep = keep_a
        self.p_drop = drop_a
        self.qdhat_inv = _shoup_pair(
            np.array([pow(qd // p, -1, p) for p in drop], np.uint64).reshape(Ld, 1),
            drop_a,
        )
        qdhat_mod_k = np.zeros((Ld, Lk, 1), np.uint64)
        for i, p in enumerate(drop):
            for j, b in enumerate(keep):
                qdhat_mod_k[i, j, 0] = (qd // p) % b
        self.qdhat_mod_k = _shoup_pair(qdhat_mod_k, keep_a[None])
        self.qd_mod_k = _shoup_pair(
            np.array([qd % b for b in keep], np.uint64).reshape(Lk, 1), keep_a
        )
        self.qdinv_mod_k = _shoup_pair(
            np.array([pow(qd % b, -1, b) for b in keep], np.uint64).reshape(Lk, 1),
            keep_a,
        )
        self._inv_drop_np = np.array([1.0 / p for p in drop]).reshape(Ld, 1)

    def rescale(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(..., L, N) coefficient-domain residues -> (..., L - n_drop, N).
        A CUDA tensor goes to the HPS kernel, bit-exact with
        ``rescale_plain``."""
        if coeffs.is_cuda:
            return hps_cuda.rescale_extend(coeffs.contiguous(), rescaler=self)[0]
        return self.rescale_plain(coeffs)

    def rescale_extend(self, coeffs: torch.Tensor, extension: BasisExtension):
        """(``rescale(coeffs)``, ``extension.convert`` of it): on a CUDA
        tensor one pass, whose rescaled residues go to the extension from
        registers."""
        if coeffs.is_cuda:
            return hps_cuda.rescale_extend(coeffs.contiguous(), self, extension)
        kept = self.rescale_plain(coeffs)
        return kept, extension.convert_plain(kept)

    def rescale_plain(self, coeffs: torch.Tensor) -> torch.Tensor:
        """``rescale`` in plain PyTorch, on any device."""
        c = self._consts(coeffs.device)
        Lk = len(self.keep_primes)
        p_k = c["p_keep"]
        c_keep = coeffs[..., :Lk, :]
        r = coeffs[..., Lk:, :]
        y = shoup_mul(r, *c["qdhat_inv"], c["p_drop"])
        w, wq = c["qdhat_mod_k"]
        terms = shoup_mul(y[..., :, None, :], w, wq, p_k)  # (..., Ld, Lk, N)
        acc = modsum(terms, p_k, axis=-3)
        s = torch.sum(y.double() * c["_inv_drop_np"], dim=-2)
        v = torch.floor(s)
        corr = (v + (s - v > 0.5).double()).long()  # v + centering, < Ld + 1
        r_c = sub_mod(acc, shoup_mul(corr[..., None, :], *c["qd_mod_k"], p_k), p_k)
        return shoup_mul(sub_mod(c_keep, r_c, p_k), *c["qdinv_mod_k"], p_k)


class BFVMulConverter(_DeviceConsts):
    """RNS machinery for textbook HPS-style BFV ct x ct multiplication:

      1. ``extend_q_to_aux`` -- fast base conversion q -> aux = {b_1..b_K,
         m_r}, overflow count float-corrected (a miss is absorbed as noise);
      2. ``scale_round`` -- y = round(t * d / q) over aux;
      3. ``exact_to_q`` -- integer-exact Shenoy-Kumaresan aux -> q through
         the redundant modulus m_r.

    The aux base is grown until B > 9*t*n*q (2x margin over the worst-case
    2*|y|); ``plan_aux`` is its NTT plan.
    """

    _CONSTS = ("p_q", "p_aux", "t_q", "t_aux", "qinv_aux", "c_mod_aux", "c_mod_q",
               "p_b", "bhat_inv", "bhat_mod_q", "bhat_mod_mr", "B_mod_q", "Binv_mr",
               "p_mr")

    def __init__(self, q_primes, t: int, ring_dim: int):
        from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan
        from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

        q_list = [int(p) for p in q_primes]
        L, n, t = len(q_list), int(ring_dim), int(t)
        q = math.prod(q_list)
        self.q_primes, self.t, self.n = tuple(q_list), t, n

        need = 9 * t * n * q  # 2x margin over the worst-case 2*|y|
        K = max(1, (need.bit_length() + 30) // 31)
        while True:
            aux = ntt_primes(K + 1, 31, 2 * n, avoid=tuple(q_list) + (t,))
            B = math.prod(aux[:K])
            if B > need:
                break
            K += 1
        self.aux_primes = aux  # b_1..b_K, m_r  (m_r last)
        self.K, self.B = K, B
        m_r = aux[K]
        assert m_r > K + 1
        self.plan_aux = NTTPlan(n, aux)

        KA = K + 1
        q_a = np.array(q_list, np.uint32).reshape(L, 1)
        aux_a = np.array(aux, np.uint32).reshape(KA, 1)
        self.p_q = q_a
        self.p_aux = aux_a
        self.q_to_aux = BasisExtension(q_list, aux)
        self.t_q = _shoup_pair(
            np.array([t % p for p in q_list], np.uint64).reshape(L, 1), q_a
        )
        self.t_aux = _shoup_pair(
            np.array([t % b for b in aux], np.uint64).reshape(KA, 1), aux_a
        )
        self.qinv_aux = _shoup_pair(
            np.array([pow(q % b, -1, b) for b in aux], np.uint64).reshape(KA, 1),
            aux_a,
        )

        c = B >> 1  # centering offset: y + c in [0, B)
        self.c_mod_aux = np.array([c % b for b in aux], np.uint32).reshape(KA, 1)
        self.c_mod_q = np.array([c % p for p in q_list], np.uint32).reshape(L, 1)
        bs = aux[:K]
        b_a = np.array(bs, np.uint32).reshape(K, 1)
        self.p_b = b_a
        self.bhat_inv = _shoup_pair(
            np.array([pow(B // b, -1, b) for b in bs], np.uint64).reshape(K, 1),
            b_a,
        )
        bhat_mod_q = np.zeros((K, L, 1), np.uint64)
        for i, b in enumerate(bs):
            for j, p in enumerate(q_list):
                bhat_mod_q[i, j, 0] = (B // b) % p
        self.bhat_mod_q = _shoup_pair(bhat_mod_q, q_a[None])
        self.bhat_mod_mr = _shoup_pair(
            np.array([(B // b) % m_r for b in bs], np.uint64).reshape(K, 1),
            np.uint64(m_r),
        )
        self.B_mod_q = _shoup_pair(
            np.array([B % p for p in q_list], np.uint64).reshape(L, 1), q_a
        )
        self.Binv_mr = (
            np.uint32(pow(B % m_r, -1, m_r)),
            np.uint32(shoup_host(pow(B % m_r, -1, m_r), m_r)),
        )
        self.p_mr = np.uint32(m_r)

    def extend_q_to_aux(self, x: torch.Tensor, correction: bool = True) -> torch.Tensor:
        """(..., L, N) coefficient-domain residues over q -> (..., K+1, N)
        over aux, centered representative up to a rare +-q float miss.
        correction=False skips the float overflow count (result x + u*q,
        u in [0, L)): ``BasisExtension.convert`` from q to aux."""
        return self.q_to_aux.convert(x, correction)

    def scale_round(self, d_q: torch.Tensor, d_aux: torch.Tensor) -> torch.Tensor:
        """y = round(t*d/q) over aux from d's coefficient-domain residues
        over q (..., L, N) and over aux (..., K+1, N); r = [t*d]_q's
        extension is lazy (an overshoot u*q shifts y by exactly -u). A CUDA
        tensor goes to the HPS kernel, bit-exact with ``scale_round_plain``."""
        if d_q.is_cuda:
            return hps_cuda.scale_exact(d_q.contiguous(), d_aux.contiguous(), self, exact=False)
        return self.scale_round_plain(d_q, d_aux)

    def scale_round_to_q(self, d_q: torch.Tensor, d_aux: torch.Tensor) -> torch.Tensor:
        """``exact_to_q(scale_round(d_q, d_aux))``: on a CUDA tensor one
        pass, y kept in registers."""
        if d_q.is_cuda:
            return hps_cuda.scale_exact(d_q.contiguous(), d_aux.contiguous(), self)
        return self.exact_to_q_plain(self.scale_round_plain(d_q, d_aux))

    def scale_round_plain(self, d_q: torch.Tensor, d_aux: torch.Tensor) -> torch.Tensor:
        """``scale_round`` in plain PyTorch, on any device."""
        c = self._consts(d_q.device)
        p_aux = c["p_aux"]
        r = shoup_mul(d_q, *c["t_q"], c["p_q"])
        r_aux = self.q_to_aux.convert_plain(r, correction=False)
        td = shoup_mul(d_aux, *c["t_aux"], p_aux)
        return shoup_mul(sub_mod(td, r_aux, p_aux), *c["qinv_aux"], p_aux)

    def exact_to_q(self, y: torch.Tensor) -> torch.Tensor:
        """(..., K+1, N) residues of centered y (|y| < B/2) -> exact
        (..., L, N) residues over q (Shenoy-Kumaresan via m_r). A CUDA
        tensor goes to the HPS kernel, bit-exact with ``exact_to_q_plain``."""
        if y.is_cuda:
            return hps_cuda.scale_exact(None, y.contiguous(), self, scale=False)
        return self.exact_to_q_plain(y)

    def exact_to_q_plain(self, y: torch.Tensor) -> torch.Tensor:
        """``exact_to_q`` in plain PyTorch, on any device."""
        c = self._consts(y.device)
        K = self.K
        p_q, p_mr = c["p_q"], c["p_mr"]
        yp = add_mod(y, c["c_mod_aux"], c["p_aux"])
        y_b, y_mr = yp[..., :K, :], yp[..., K, :]
        z = shoup_mul(y_b, *c["bhat_inv"], c["p_b"])  # (..., K, N)
        w, wq = c["bhat_mod_q"]
        acc = modsum(shoup_mul(z[..., :, None, :], w, wq, p_q), p_q, axis=-3)
        s_mr = modsum(shoup_mul(z, *c["bhat_mod_mr"], p_mr), p_mr, axis=-2)
        u = shoup_mul(sub_mod(s_mr, y_mr, p_mr), *c["Binv_mr"], p_mr)
        uB = shoup_mul(u[..., None, :], *c["B_mod_q"], p_q)
        return sub_mod(sub_mod(acc, uB, p_q), c["c_mod_q"], p_q)
