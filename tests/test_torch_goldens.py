"""The reference's golden tests through the port, against the JAX package.

The JAX side runs the JAX package's own golden tests
(``tests/test_goldens_reference_scale.py``, loaded from its file) at a small
ring, under ``jax.enable_x64(True)``, with recorders around its context and
PIE engines; the port side runs ``tests/torch_golden_cases.py`` at the same
ring on the CPU. Keys and encryptions are random in both packages, so the
port replays the JAX package's: its context's keygen and encrypt return the
JAX values carried across with ``convert`` (and check that they are asked
for the same plaintexts). On those, the hashed tables, the packed table
``table_pt`` and the result ciphertexts must be bit-equal (tolerance 0),
and the decrypted zero patterns and noise equal. The port's goldens with
their own keys must meet the reference's pass criteria too. The rings are
the smallest that hold each golden's slot layout: 101 slots for TestFHEPIE,
12 for TestFHEInnerP; 16 for TestBatchedFHEPIE (2 slots) as well.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import torch_golden_cases as goldens
from nested_hashing_psi_tpu_torch import convert
from nested_hashing_psi_tpu_torch.fhe.bgv import PublicKey

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = {
    "fhe_pie": ("test_golden_fhe_pie_15000_items_ring16384", goldens.golden_fhe_pie, 128),
    "batched_fhe_pie": ("test_golden_batched_fhe_pie_reference_geometry",
                        goldens.golden_batched_fhe_pie, 16),
    "inner_product": ("test_golden_inner_product_known_vector_with_serialization",
                      goldens.golden_inner_product, 16),
}


def _jax_goldens():
    """A private copy of the JAX package's golden test module (its globals
    are patched below; the module pytest collects stays untouched)."""
    path = os.path.join(HERE, "test_goldens_reference_scale.py")
    spec = importlib.util.spec_from_file_location("_jax_goldens_small_ring", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(a):
    return np.asarray(a)


def _record_jax(name: str, ring: int, monkeypatch) -> dict:
    """Run the JAX golden at ``ring`` and record what it drew and made."""
    jg = _jax_goldens()
    rec = {"keygen": [], "galois": [], "relin": [], "enc": [], "decrypt": [], "pie": []}

    def make_context(params, seed):
        ctx = real_make_context(params, seed=seed)

        def wrap(method, log, keep):
            def call(*args, **kwargs):
                out = method(*args, **kwargs)
                rec[log].append(keep(args, out))
                return out
            return call

        ctx.keygen = wrap(ctx.keygen, "keygen", lambda a, out: out)
        ctx.galois_keygen = wrap(ctx.galois_keygen, "galois", lambda a, out: (list(a[1]), out))
        ctx.relin_keygen = wrap(ctx.relin_keygen, "relin", lambda a, out: out)
        ctx.encrypt_sk = wrap(ctx.encrypt_sk, "enc", lambda a, out: (_np(a[0]), out))
        ctx.encrypt_pk = wrap(ctx.encrypt_pk, "enc", lambda a, out: (_np(a[0]), out))
        ctx.decrypt = wrap(ctx.decrypt, "decrypt", lambda a, out: (a[0], out))
        return ctx

    def recording(cls):
        class Recording(cls):
            def __init__(self, ctx, hct, *args, **kwargs):
                super().__init__(ctx, hct, *args, **kwargs)
                rec["pie"].append((hct.table.copy(), _np(self.table_pt)))
        return Recording

    real_make_context = jg.make_context
    monkeypatch.setattr(jg, "RING", ring)
    monkeypatch.setattr(jg, "make_context", make_context)
    monkeypatch.setattr(jg, "SimpleFHEPIE", recording(jg.SimpleFHEPIE))
    monkeypatch.setattr(jg, "BatchedFHEPIE", recording(jg.BatchedFHEPIE))
    with jax.enable_x64(True):
        getattr(jg, name)()
    return rec


def _replay_into_port(rec: dict, monkeypatch) -> list:
    """Make the port's golden draw the JAX package's keys and encryptions;
    -> the encryptions not yet drawn."""
    enc = list(rec["enc"])
    real_make_context = goldens.make_context

    def make_context(params, seed, *, device):
        ctx = real_make_context(params, seed, device=device)
        dev = ctx.device

        def keygen():
            jsk, jpk = rec["keygen"][0]
            return (convert.secret_key_from_numpy(_np(jsk.s_mont), _np(jsk.s_ntt), dev),
                    PublicKey(b_mont=convert.from_numpy(_np(jpk.b_mont), dev),
                              a_mont=convert.from_numpy(_np(jpk.a_mont), dev)))

        def galois_keygen(sk, elements):
            want, jgks = rec["galois"][0]
            assert list(elements) == want
            return convert.galois_keys_from_numpy(
                {k: (_np(g.b_mont), _np(g.a_mont)) for k, g in jgks.items()}, dev)

        def relin_keygen(sk):
            jrlk = rec["relin"][0]
            return convert.relin_key_from_numpy(_np(jrlk.b_mont), _np(jrlk.a_mont), dev)

        def encrypt(pt, key):
            jpt, jct = enc.pop(0)
            np.testing.assert_array_equal(convert.to_numpy(pt), jpt)
            return convert.ciphertext_from_numpy(_np(jct.data), dev, jct.form, jct.scale)

        ctx.keygen, ctx.galois_keygen, ctx.relin_keygen = keygen, galois_keygen, relin_keygen
        ctx.encrypt_sk = ctx.encrypt_pk = encrypt
        return ctx

    monkeypatch.setattr(goldens, "make_context", make_context)
    return enc


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    name, fn, ring = CASES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        rec = _record_jax(name, ring, mp)
        left = _replay_into_port(rec, mp)
        port = fn("cpu", ring)
    assert not left, "the port drew fewer encryptions than the JAX golden"
    return request.param, rec, port


def test_golden_tables_bit_equal(pair):
    """The hashed table (the port's hashing copies, 15,000 items with no
    stash in TestFHEPIE) and the packed plaintext table."""
    case, rec, port = pair
    if case == "inner_product":  # no table: the check is the key material below
        assert not rec["pie"] and rec["galois"] and len(rec["enc"]) == 2
        return
    (table, table_pt), = rec["pie"]
    np.testing.assert_array_equal(port["table"], table)
    np.testing.assert_array_equal(convert.to_numpy(port["table_pt"]), table_pt)


def test_golden_result_bit_equal(pair):
    """The ciphertext the golden decrypts: the PIE's result, or the merged
    inner products; data, form and scale."""
    _, rec, port = pair
    (jct, _), = rec["decrypt"]
    got = port["result"]
    assert (got.form, got.scale) == (jct.form, jct.scale)
    np.testing.assert_array_equal(convert.to_numpy(got.data), _np(jct.data))


def test_golden_zero_pattern_and_noise_equal(pair):
    case, rec, port = pair
    (_, (slots, noise)), = rec["decrypt"]
    slots = np.asarray(slots, dtype=object)
    if case == "fhe_pie":
        want = slots.reshape(3, -1) == 0
    elif case == "batched_fhe_pie":
        want = slots == 0
    else:
        want = slots[:4] == 0
        assert port["slots"] == [0, 1, 0, 1] == [int(v) for v in slots[:4]]
    np.testing.assert_array_equal(port["zeros"], want)
    assert port["noise"] == noise


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_with_the_ports_own_keys(case):
    """The port's own keygen and encryption meet the reference's criteria
    (the function raises otherwise); no kernel runs on the CPU."""
    _, fn, ring = CASES[case]
    out = fn("cpu", ring)
    assert out["noise"] < out["noise_bound"]
    assert out["launches"] == {"ntt_fwd": 0, "ntt_inv": 0, "pie_ip": 0}
